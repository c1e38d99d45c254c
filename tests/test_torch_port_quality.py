"""The quality-instrument path against the JAX tools on the CPU: the hard
corpus (``smoke_data.make_kashtanka_hard`` against
``tools/make_smoke_datasets.py``), candR@K (``quality_instrument.cand_recall``),
the rank diff (``diff_tsv_ranks.compare`` and its exit status) on JAX's
committed hard-corpus tsvs and on seeded edge cases, the instrument's pass
plan with ``subprocess.run`` recorded, and one real float pass of the port
over a 3-identity corpus.
"""

import importlib
import io
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pets_face_recognition_tpu_torch import (diff_tsv_ranks, native, quality_instrument,
                                             retrieval, smoke_data)

REPO = Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "golden" / "rank_hard"
sys.path.insert(0, str(REPO / "tools"))
j_make = importlib.import_module("make_smoke_datasets")
j_quality = importlib.import_module("quality_instrument")
j_diff = importlib.import_module("diff_tsv_ranks")

torch.set_num_threads(1)

HARD_GT = {f"rl{900000 + i}": f"rf{950000 + i}" for i in range(120)}
CKPT_VARS = ("PFR_KEYPOINT_CKPT", "PFR_MASK_CKPT", "PFR_CAT_HEAD_FE_CKPT",
             "PFR_DOG_HEAD_FE_CKPT", "PFR_CAT_BODY_FE_CKPT", "PFR_DOG_BODY_FE_CKPT")


def test_hard_corpus_matches_the_tool(tmp_path):
    """The same tree, ``card.json`` files and ``hard_gt.json``, and the same
    JPEG bytes (libjpeg, quality 92) as the tool's at a small size."""
    a, b = tmp_path / "tool", tmp_path / "port"
    kw = dict(n_ids=4, n_clusters=3, n_distractors=4, n_imgs=1)
    assert j_make.make_kashtanka_hard(a, **kw).relative_to(a) == \
        smoke_data.make_kashtanka_hard(b, **kw).relative_to(b)
    files = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
    assert len(files) == 2 * 4 + 4 + 4 + 1 + (2 * 4 + 4 + 4)   # images, card.json, gt
    assert native.route() == "libjpeg"
    for rel in files:
        assert (a / rel).read_bytes() == (b / rel).read_bytes(), rel
    assert json.loads((b / "hard_gt.json").read_text()) == \
        {f"rl{900000 + i}": f"rf{950000 + i}" for i in range(4)}


def test_cand_recall_matches_jax_on_the_committed_tsvs():
    """JAX's TPU-era hard-corpus tsvs: the same report, and the float one is
    the committed table's ``float_resnet50_f32`` row."""
    table = json.loads((GOLDEN / "quality_table.json").read_text())
    for name in ("float", "int8ship"):
        tsv = GOLDEN / f"tsv_{name}.tsv"
        got = quality_instrument.cand_recall(tsv, HARD_GT)
        assert got == j_quality.cand_recall(tsv, HARD_GT)
        assert list(got) == ["candR@1", "candR@10", "candR@100", "queries_with_rows",
                             "queries_total"]
    assert quality_instrument.cand_recall(GOLDEN / "tsv_float.tsv", HARD_GT) == \
        table["float_resnet50_f32"]


@pytest.mark.parametrize("pair", [("tsv_float.tsv", "tsv_int8ship.tsv"),
                                  ("tsv_float.tsv", "tsv_float.tsv"),
                                  ("tsv_int8ship.tsv", "tsv_float.tsv")])
@pytest.mark.parametrize("tol", [1e-6, 1e-3, 1.0])
def test_compare_matches_jax_on_the_committed_tsvs(pair, tol):
    a, b = (str(GOLDEN / p) for p in pair)
    got = diff_tsv_ranks.compare(a, b, tol)
    want = j_diff.compare(a, b, tol)
    assert got == want and list(got) == list(want)


def edge_tsvs(root: Path) -> dict[str, Path]:
    """Seeded tsvs written with the port's writer: a base table and copies
    with a query missing, an answer list cut short, another query set, moved
    scores, an empty answer and score cells, NaN and infinite scores, and a
    swapped top-1."""
    rng = np.random.RandomState(71)
    gallery = [f"rf{950000 + i}" for i in range(30)]
    rows = []
    for i in range(12):
        scores = np.sort(rng.rand(3))[::-1]
        answer = ",".join(rng.permutation(gallery)[:15])
        rows.append((f"rl{900000 + i}", *map(float, scores), answer))
    variants = {"base": rows,
                "missing": rows[:4] + rows[5:],
                "short": [r if i != 3 else r[:4] + (",".join(r[4].split(",")[:6]),)
                          for i, r in enumerate(rows)],
                "other_set": rows[2:] + [("rl999999", 0.5, 0.4, 0.3, "rf950001")],
                "disjoint": [("rl999999", 0.5, 0.4, 0.3, "rf950001")],
                "scores": [(r[0], r[1] + 1e-4 * i, r[2], r[3] - 2e-3, r[4])
                           for i, r in enumerate(rows)],
                "empty_cells": [r if i != 6 else (r[0], None, None, r[3], None)
                                for i, r in enumerate(rows)],
                "nan_inf": [r if i % 4 else (r[0], math.nan, -math.inf if i else math.inf,
                                             math.nan, r[4]) for i, r in enumerate(rows)],
                "top1": [r if i % 5 else r[:4] + (",".join([r[4].split(",")[1],
                                                            r[4].split(",")[0]]
                                                           + r[4].split(",")[2:]),)
                         for i, r in enumerate(rows)]}
    paths = {}
    for name, rs in variants.items():
        paths[name] = root / f"{name}.tsv"
        retrieval.write_tsv(rs, paths[name])
    return paths


def test_edge_cases_match_jax(tmp_path, capsys):
    """Each variant against the base both ways: the report, the printed lines
    and the exit status equal JAX's; candR@K equal JAX's on each, with a
    ground truth that holds a query no tsv has."""
    paths = edge_tsvs(tmp_path)
    gt = {f"rl{900000 + i}": f"rf{950000 + i}" for i in range(13)}
    verdicts = {}
    for name, path in paths.items():
        assert quality_instrument.cand_recall(path, gt) == j_quality.cand_recall(path, gt), name
        for a, b in ((paths["base"], path), (path, paths["base"])):
            for tol in (1e-6, 1e-2):
                report = diff_tsv_ranks.compare(str(a), str(b), tol)
                assert report == j_diff.compare(str(a), str(b), tol), (name, tol)
                rc = diff_tsv_ranks.main([str(a), str(b), "--score-tol", str(tol)])
                ours = capsys.readouterr().out
                mp = pytest.MonkeyPatch()
                mp.setattr(sys, "argv", ["diff_tsv_ranks.py", str(a), str(b),
                                         "--score-tol", str(tol)])
                try:
                    j_rc = j_diff.main()
                finally:
                    mp.undo()
                assert (rc, ours) == (j_rc, capsys.readouterr().out), (name, tol)
                verdicts[name, tol, a == paths["base"]] = rc
    assert verdicts["base", 1e-6, True] == 0 and verdicts["scores", 1e-2, True] == 0
    for name in ("missing", "short", "other_set", "disjoint", "empty_cells", "nan_inf", "top1"):
        assert verdicts[name, 1e-2, True] == 1, name
    assert verdicts["scores", 1e-6, True] == 1


def test_tsv_cells_read_and_write_as_pandas(tmp_path):
    """``retrieval.write_tsv`` writes a NaN score as pandas' ``to_csv`` does
    (an empty cell) and ``read_tsv`` reads pandas' missing-value strings as
    missing and ``inf`` as infinite, as ``read_csv`` does."""
    import pandas as pd

    rows = [("rl1", math.nan, math.inf, -math.inf, "rf1,rf2"), ("rl2", 0.25, None, 1e-20, None)]
    retrieval.write_tsv(rows, tmp_path / "port.tsv")
    buf = io.StringIO()
    pd.DataFrame(rows, columns=retrieval.COLUMNS).to_csv(buf, sep="\t", index=False)
    assert (tmp_path / "port.tsv").read_text() == buf.getvalue()
    cells = ["nan", "NaN", "NA", "null", "None", "", "-nan", "inf", "-Infinity", "INF", "0.5"]
    text = "\t".join(retrieval.COLUMNS) + "\n" + "".join(
        f"q{i}\t{c}\t{c}\t1\t{c or 'x'}\n" for i, c in enumerate(cells))
    (tmp_path / "cells.tsv").write_text(text)
    want = pd.read_csv(tmp_path / "cells.tsv", sep="\t")
    got = retrieval.read_tsv(tmp_path / "cells.tsv")
    for row, (_, w) in zip(got, want.iterrows()):
        for col, v in zip(retrieval.COLUMNS, row):
            if pd.isna(w[col]):
                assert v is None, (row, col)
            else:
                assert v == w[col], (row, col)


def plan(tool, argv: list[str], monkeypatch, gt: dict) -> tuple[list, dict]:
    """Run ``tool.main`` with ``subprocess.run`` recorded: each call's chain
    (``head`` or ``ensemble``), its ``PFR_*`` variables (the state file by
    name) and its tsv's name; each call writes a tsv that ranks the true
    match first for every second query. Returns the calls and the table."""
    calls = []

    def fake_run(cmd, check=False, cwd=None, env=None):
        assert check
        out = Path(cmd[cmd.index("--output") + 1])
        ensemble = ("--body" in cmd) or cmd[1].endswith("generate_tsv_to_reproduce1.py")
        pfr = {k: v for k, v in env.items() if k.startswith("PFR_")}
        pfr["PFR_QUANT_STATE"] = Path(pfr["PFR_QUANT_STATE"]).name
        calls.append(("ensemble" if ensemble else "head", pfr, out.name))
        rows = [(q, 0.9, 0.8, 0.7, (m if i % 2 == 0 else "rfX") + ",rfY")
                for i, (q, m) in enumerate(gt.items()) if i != 1]
        retrieval.write_tsv(rows, out)
        return subprocess.CompletedProcess(cmd, 0)

    monkeypatch.setattr(subprocess, "run", fake_run)
    monkeypatch.setattr(sys, "argv", ["quality_instrument.py"] + argv)
    if tool is quality_instrument:
        assert tool.main(argv) == 0
    else:
        tool.main()
    out = Path(argv[argv.index("--out") + 1])
    return calls, json.loads((out / "quality_table.json").read_text())


@pytest.mark.parametrize("case", ["all", "default", "no_mobile", "ensemble"])
def test_pass_plan_matches_jax(case, tmp_path, monkeypatch, capsys):
    """Each pass's ``PFR_*`` variables, the calibrate -> int8 order of every
    int8 row, the chain and the tsv equal the JAX tool's, for every row of
    ``CONFIGS``; the mobile rows are skipped without ``--mobile-ckpt``; a
    components value left in the caller's environment reaches no int8 row."""
    assert list(quality_instrument.CONFIGS) == list(j_quality.CONFIGS)
    for name, overrides in j_quality.CONFIGS.items():
        assert quality_instrument.CONFIGS[name] == overrides, name
    gt = {f"rl{900000 + i}": f"rf{950000 + i}" for i in range(4)}
    (tmp_path / "gt.json").write_text(json.dumps(gt))
    for var in CKPT_VARS:
        monkeypatch.setenv(var, f"/ckpt/{var.lower()}")
    monkeypatch.setenv("PFR_RETRIEVAL_THR", "0.0")
    monkeypatch.setenv("PFR_QUANT_COMPONENTS", "kp_head")
    monkeypatch.delenv("PFR_KEYPOINT_ARCH", raising=False)
    monkeypatch.delenv("PFR_INPUT_DTYPE", raising=False)
    extra = {"all": ["--configs", *j_quality.CONFIGS, "--mobile-ckpt", "/ckpt/mobile"],
             "default": [], "no_mobile": ["--configs", "float_mobile_f32", "int8_resnet50_f32",
                                          "int8_mobile_f32"],
             "ensemble": ["--ensemble", "--configs", "float_resnet50_f32",
                          "int8ship_resnet50_bf16in"]}[case]
    runs = {}
    for label, tool in (("jax", j_quality), ("port", quality_instrument)):
        argv = ["--data", str(tmp_path / "data"), "--gt", str(tmp_path / "gt.json"),
                "--out", str(tmp_path / label)] + extra
        if tool is quality_instrument:
            argv += ["--device", "cpu"]
        runs[label] = plan(tool, argv, monkeypatch, gt)
        printed = capsys.readouterr().out
        runs[label] += ([ln for ln in printed.splitlines() if ln.startswith(("skip", "|"))],)
    (calls, table, lines), (j_calls, j_table, j_lines) = runs["port"], runs["jax"]
    assert calls == j_calls and table == j_table and lines == j_lines
    modes = [c[1]["PFR_QUANT_MODE"] for c in calls]
    for i, mode in enumerate(modes):
        if mode == "calibrate":
            assert modes[i + 1] == "int8" and calls[i + 1][1] == dict(calls[i][1],
                                                                     PFR_QUANT_MODE="int8")
        if mode:
            assert calls[i][1]["PFR_QUANT_COMPONENTS"] in ("embedder,kp_head",
                                                           "embedder,detector,kp_head")
    if case == "all":
        assert len(calls) == 8 + 5 and modes.count("calibrate") == 5
        assert [c[1]["PFR_KEYPOINT_CKPT"] for c in calls if "mobile" in c[2]] == \
            [str(Path("/ckpt/mobile").resolve())] * 3
    if case in ("default", "no_mobile"):
        assert not any("mobile" in c[2] for c in calls)
    if case == "no_mobile":
        assert lines[:2] == ["skip float_mobile_f32: no --mobile-ckpt",
                             "skip int8_mobile_f32: no --mobile-ckpt"]
    if case == "ensemble":
        assert {c[0] for c in calls} == {"ensemble"}


def test_real_float_pass_on_the_cpu(tmp_path):
    """``quality_instrument --device cpu`` over 3 identities (12 photos): one
    ``generate_tsv`` subprocess at full width with seeded weights (every
    checkpoint variable set empty: explicit, and naming none), then the
    table (3 queries, candR@1 <= @10 <= @100 in [0, 1]), the pass's seconds
    and the markdown table."""
    root = tmp_path / "hard"
    data = smoke_data.make_kashtanka_hard(root, n_ids=3, n_clusters=2, n_distractors=2,
                                          n_imgs=1)
    out = tmp_path / "out"
    env = {k: v for k, v in os.environ.items() if not k.startswith("PFR_")}
    env.update({var: "" for var in CKPT_VARS}, PFR_RETRIEVAL_THR="0.0", OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    code = ("import sys\nfrom pets_face_recognition_tpu_torch import quality_instrument\n"
            "sys.exit(quality_instrument.main(sys.argv[1:]))\n")
    proc = subprocess.run([sys.executable, "-c", code, "--data", str(data), "--gt",
                           str(root / "hard_gt.json"), "--out", str(out), "--configs",
                           "float_resnet50_f32", "--device", "cpu"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    row = json.loads((out / "quality_table.json").read_text())["float_resnet50_f32"]
    assert row["queries_total"] == 3 and 0 < row["queries_with_rows"] <= 3
    assert 0.0 <= row["candR@1"] <= row["candR@10"] <= row["candR@100"] <= 1.0
    passes = json.loads((out / "quality_passes.json").read_text())
    assert list(passes) == ["float_resnet50_f32:float"]
    assert passes["float_resnet50_f32:float"]["photos"] == 12
    assert "| float_resnet50_f32 |" in proc.stdout
    lines = (out / "tsv_float_resnet50_f32.tsv").read_text().splitlines()
    assert lines[0] == "query\tmatched_1\tmatched_3\tmatched_10\tanswer"


def test_a_failed_pass_exits_nonzero(tmp_path, monkeypatch):
    """A pass whose ``generate_tsv`` fails (a checkpoint variable naming
    nothing) stops the instrument with the subprocess's error, as JAX's
    ``check=True``."""
    def failing_run(cmd, check=False, cwd=None, env=None):
        assert check
        raise subprocess.CalledProcessError(1, cmd)

    monkeypatch.setattr(subprocess, "run", failing_run)
    (tmp_path / "gt.json").write_text("{}")
    for var in CKPT_VARS:
        monkeypatch.setenv(var, "")
    monkeypatch.setenv("PFR_RETRIEVAL_THR", "0.0")
    with pytest.raises(subprocess.CalledProcessError):
        quality_instrument.main(["--data", str(tmp_path), "--gt", str(tmp_path / "gt.json"),
                                 "--out", str(tmp_path / "o"), "--configs",
                                 "float_resnet50_f32", "--device", "cpu"])
