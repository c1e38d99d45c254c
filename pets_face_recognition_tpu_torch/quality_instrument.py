"""Quality instrument: candR@K of the whole retrieval chain over the hard
corpus, configuration by configuration (counterpart of the JAX
``tools/quality_instrument.py``).

The easy corpus saturates candR@K at 1.0, so a precision's effect on the
ranking has no denominator there. This tool runs ``generate_tsv`` (the head
chain, or with ``--ensemble`` the head+body one) in a subprocess for each
configuration over ``smoke_data.make_kashtanka_hard``'s near-duplicate
identities and tables candR@1/10/100 for each:

- float against int8 PTQ (``PFR_QUANT_MODE``; an int8 row calibrates in one
  pass, then serves in a second, with its components pinned in
  ``PFR_QUANT_COMPONENTS``, never inherited from the caller's environment),
- the ``resnet50`` against the ``mobile`` keypoint detector
  (``PFR_KEYPOINT_ARCH``; the mobile rows need ``--mobile-ckpt``),
- float32 against bfloat16 inputs (``PFR_INPUT_DTYPE``).

candR@K is the share of query cards whose true match is in the top K of the
ranked answer list; a query with no tsv row misses at every K.

    python -m pets_face_recognition_tpu_torch.quality_instrument \\
        --data <root>/test_hard --gt <root>/hard_gt.json --out <out> \\
        [--configs NAME ...] [--mobile-ckpt <run>/checkpoints] [--ensemble] \\
        [--device cuda|cpu]

Checkpoints come from the ``PFR_*`` variables; an unset one defaults to the
newest run under ``results_smoke/`` in the working directory whose folder
holds the port's recipe (``keypoint_smoke.py``, ``mask_smoke.py``,
``fe_smoke.py``; ``main`` copies the config there), and
``PFR_RETRIEVAL_THR`` to 0.5. Writes ``<out>/quality_table.json`` (merged
into the one already there), ``<out>/quality_passes.json`` (each pass's
seconds and photos/s) and prints a markdown table. A pass that fails makes
the tool exit nonzero. Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

from .device import resolve_device
from .diff_tsv_ranks import ranked, read_rows

# the checkout: the subprocesses run from it, so ``-m`` finds the package
REPO = Path(__file__).resolve().parent.parent


def cand_recall(tsv: Path, gt: dict[str, str], ks=(1, 10, 100)) -> dict:
    """candR@K for each of ``ks`` of a tsv against ``gt`` (query -> its true
    match), with the number of queries that have a row and of all queries."""
    rows = read_rows(tsv)
    hits = {k: 0 for k in ks}
    found_rows = 0
    for q, match in gt.items():
        if q not in rows:
            continue  # no prediction: a miss at every K
        found_rows += 1
        answers = ranked(rows[q])
        for k in ks:
            if match in answers[:k]:
                hits[k] += 1
    n = len(gt)
    out = {f"candR@{k}": round(hits[k] / n, 4) for k in ks}
    out["queries_with_rows"] = found_rows
    out["queries_total"] = n
    return out


def run_pass(name: str, env_overrides: dict, data: Path, out_dir: Path, ensemble: bool,
             quant_state: Path, device: str = "cuda", timings: dict | None = None) -> Path:
    """One chain pass of the configuration ``name``; an int8 one
    (``"_int8"`` in ``env_overrides``) calibrates first. Each subprocess's
    seconds go into ``timings[f"{name}:{mode or 'float'}"]``."""
    tsv = Path(out_dir).resolve() / f"tsv_{name}.tsv"

    def _run(mode: str) -> None:
        env = dict(os.environ)
        env.update(env_overrides)
        env["PFR_QUANT_MODE"] = mode
        env["PFR_QUANT_STATE"] = str(Path(quant_state).resolve())
        cmd = [sys.executable, "-m", "pets_face_recognition_tpu_torch.generate_tsv",
               "--data", str(Path(data).resolve()),
               "--stock-preds", str(tsv.with_name("no_stock_preds.tsv")),
               "--output", str(tsv), "--device", device] + (["--body"] if ensemble else [])
        print(f"[{name}] PFR_QUANT_MODE={mode!r} "
              + " ".join(f"{k}={v}" for k, v in env_overrides.items()), flush=True)
        t = time.perf_counter()
        subprocess.run(cmd, check=True, cwd=REPO, env=env)
        if timings is not None:
            timings[f"{name}:{mode or 'float'}"] = time.perf_counter() - t

    if env_overrides.pop("_int8", False):
        _run("calibrate")
        _run("int8")
    else:
        _run("")
    return tsv


_SHIP = "embedder,kp_head"  # the shipping default: the detector's int8 stays opt-in
_ALL = "embedder,detector,kp_head"
# name -> variable overrides; "_int8" asks for the calibrate -> int8 passes.
# "int8" rows quantize every component (the detector's trunk and RPN too);
# "int8ship" rows the shipping set (embedder and keypoint head). Every int8
# row pins PFR_QUANT_COMPONENTS, so that a value left in the caller's
# environment cannot relabel a row.
CONFIGS = {
    "float_resnet50_f32": {},
    "int8_resnet50_f32": {"_int8": True, "PFR_QUANT_COMPONENTS": _ALL},
    "int8ship_resnet50_f32": {"_int8": True, "PFR_QUANT_COMPONENTS": _SHIP},
    "float_resnet50_bf16in": {"PFR_INPUT_DTYPE": "bfloat16"},
    "int8_resnet50_bf16in": {"_int8": True, "PFR_INPUT_DTYPE": "bfloat16",
                             "PFR_QUANT_COMPONENTS": _ALL},
    "int8ship_resnet50_bf16in": {"_int8": True, "PFR_INPUT_DTYPE": "bfloat16",
                                 "PFR_QUANT_COMPONENTS": _SHIP},
    # the mobile rows read the MobileNetV3 checkpoint of --mobile-ckpt
    # (configs/keypoint_mobile_smoke.py, then recalibrate_bn)
    "float_mobile_f32": {"PFR_KEYPOINT_ARCH": "mobile"},
    "int8_mobile_f32": {"_int8": True, "PFR_KEYPOINT_ARCH": "mobile",
                        "PFR_QUANT_COMPONENTS": _ALL},
}


def resolve_smoke_env() -> None:
    """Default each unset checkpoint variable to the newest ``results_smoke``
    run (in the working directory) made by its recipe, and
    ``PFR_RETRIEVAL_THR`` to 0.5 (smoke detectors are weak); a variable that
    is set always wins. Exits when a needed run is missing."""
    runs_root = Path.cwd() / "results_smoke"

    def latest_by_cfg(cfg_name: str) -> str:
        for d in sorted(runs_root.glob("*/"), key=lambda p: p.name, reverse=True):
            if (d / cfg_name).exists() and any((d / "checkpoints").glob("*")):
                return str((d / "checkpoints").resolve())
        raise SystemExit(f"no results_smoke run with {cfg_name}")

    defaults = {
        "PFR_KEYPOINT_CKPT": lambda: latest_by_cfg("keypoint_smoke.py"),
        "PFR_MASK_CKPT": lambda: latest_by_cfg("mask_smoke.py"),
        "PFR_RETRIEVAL_THR": lambda: "0.5",
    }
    fe = None
    for var in ("PFR_CAT_HEAD_FE_CKPT", "PFR_DOG_HEAD_FE_CKPT",
                "PFR_CAT_BODY_FE_CKPT", "PFR_DOG_BODY_FE_CKPT"):
        if var not in os.environ:
            fe = fe or latest_by_cfg("fe_smoke.py")
            os.environ[var] = fe
    for var, fn in defaults.items():
        if var not in os.environ:
            os.environ[var] = fn()
    for var in sorted(v for v in os.environ if v.startswith("PFR_")):
        print(f"  {var}={os.environ[var]}")


def photo_count(data: Path) -> int:
    """The photos a pass reads: every file of the split but ``card.json``."""
    return sum(1 for p in Path(data).rglob("*") if p.is_file() and p.name != "card.json")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data", type=Path, required=True)
    ap.add_argument("--gt", type=Path, required=True)
    ap.add_argument("--out", type=Path, default=Path("quality_out"))
    ap.add_argument("--ensemble", action="store_true",
                    help="the head+body ensemble chain (generate_tsv --body)")
    ap.add_argument("--configs", nargs="*", default=None,
                    help=f"subset of {sorted(CONFIGS)} (default: the six resnet50 rows; "
                         "the mobile rows too with --mobile-ckpt)")
    ap.add_argument("--mobile-ckpt", type=Path, default=None,
                    help="MobileNetV3 keypoint checkpoint folder (enables the mobile rows)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    resolve_device(args.device)   # the card unless --device cpu: raises without one
    resolve_smoke_env()
    gt = json.loads(args.gt.read_text())
    args.out.mkdir(parents=True, exist_ok=True)
    names = args.configs
    if names is None:
        names = [n for n in CONFIGS if "mobile" not in n]
        if args.mobile_ckpt is not None:
            names += [n for n in CONFIGS if "mobile" in n]

    # merged into the table already there, so that the grid fills run by run
    table_path = args.out / "quality_table.json"
    table = json.loads(table_path.read_text()) if table_path.exists() else {}
    timings: dict[str, float] = {}
    for name in names:
        overrides = dict(CONFIGS[name])
        if "mobile" in name:
            if args.mobile_ckpt is None:
                print(f"skip {name}: no --mobile-ckpt")
                continue
            overrides["PFR_KEYPOINT_CKPT"] = str(args.mobile_ckpt.resolve())
        tsv = run_pass(name, overrides, args.data, args.out, args.ensemble,
                       args.out / f"quant_{name}.pkl", args.device, timings)
        table[name] = cand_recall(tsv, gt)
        print(name, table[name], flush=True)

    table_path.write_text(json.dumps(table, indent=2))
    photos = photo_count(args.data)
    passes = {k: {"seconds": s, "photos": photos, "photos_per_s": photos / s}
              for k, s in timings.items()}
    passes_path = args.out / "quality_passes.json"
    old = json.loads(passes_path.read_text()) if passes_path.exists() else {}
    passes_path.write_text(json.dumps({**old, **passes}, indent=2))
    ks = ("candR@1", "candR@10", "candR@100")
    print("\n| config | " + " | ".join(ks) + " | rows |")
    print("|---|" + "---|" * (len(ks) + 1))
    for name, m in table.items():
        print(f"| {name} | " + " | ".join(str(m[k]) for k in ks)
              + f" | {m['queries_with_rows']}/{m['queries_total']} |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
