"""Gallery retrieval: card centroids -> one score product -> ensemble rule ->
stable top-k -> tsv (counterpart of the JAX ``retrieval/__init__.py``).

A card's mean-strategy score against another is the mean over image pairs of
``(cos + 1) / 2``, which equals ``(centroid_q . centroid_g + 1) / 2`` with each
centroid the mean of the card's l2-normalised embeddings. So every query x
gallery score is one ``(Q, D) x (D, G)`` product, run with ``torch.matmul``
on the caller's device in float32 (TF32 off). The ensemble rule and the
ranking stay numpy on the host, as in the JAX package, so that the float32
means agree. Rows are tuples ``(query, matched_1, matched_3, matched_10,
answer)``; :func:`write_tsv` writes them as ``DataFrame.to_csv(sep="\\t",
index=False)`` does, without pandas.

Score dumps: :func:`calc_scores` fills an optional dict, keyed by query name,
with each query's full score row, include mask and gallery names;
:func:`write_scores_dump` saves it as the JAX package's ``PFR_SCORES_DUMP``
npz (keys ``"{query}/gallery|scores|include"``), and :func:`near_tie_report`
compares two dumps as ``tools/verify_near_tie_contract.py::compare`` does;
:func:`flush_scores_dump` writes a dump to ``PFR_SCORES_DUMP`` or a path.

With a ``mesh`` (``parallel.create_mesh``) the gallery is split over the
``data`` axis: ``pairwise_card_scores`` scores this process's gallery rows and
gathers every rank's, and :func:`sharded_topk_scores` takes a top-k a rank
and a global top-k over the gathered candidates, so that only ``(Q, k)`` a
rank crosses the processes.
"""

from __future__ import annotations

import csv
import dataclasses
import math
import os
import re
from pathlib import Path
from typing import Iterable, Mapping

import numpy as np
import torch

from . import parallel
from .device import float32_matmuls, resolve_device

# Per-species ensemble fallback thresholds (type 1 = dog, 2 = cat).
ENSEMBLE_BODY_THRESHOLDS = (0.9069641, 0.985643)
COLUMNS = ("query", "matched_1", "matched_3", "matched_10", "answer")
NUMERIC_COLUMNS = ("matched_1", "matched_3", "matched_10")


@dataclasses.dataclass
class CardRecord:
    """One pet card's image embeddings (``process_base`` output)."""

    name: str
    type: int  # animal type from card.json: 1 = dog, 2 = cat
    head_vectors: np.ndarray  # (n, D) or (0,)
    body_vectors: np.ndarray  # (m, D) or (0,)

    @property
    def has_head(self) -> bool:
        return self.head_vectors is not None and len(self.head_vectors) > 0

    @property
    def has_body(self) -> bool:
        return self.body_vectors is not None and len(self.body_vectors) > 0


def _centroid(vectors: np.ndarray, dim: int) -> tuple[np.ndarray, bool]:
    if vectors is None or len(vectors) == 0:
        return np.zeros(dim, np.float32), False
    v = np.asarray(vectors, np.float32)
    v = v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-12)
    return v.mean(axis=0), True


def build_card_matrix(cards: list[CardRecord], dim: int = 512):
    """Stack card centroids: ``(head (C, D), body (C, D), has_head (C,),
    has_body (C,), types (C,))``."""
    C = len(cards)
    head = np.zeros((C, dim), np.float32)
    body = np.zeros((C, dim), np.float32)
    has_head = np.zeros(C, bool)
    has_body = np.zeros(C, bool)
    types = np.zeros(C, np.int32)
    for i, c in enumerate(cards):
        head[i], has_head[i] = _centroid(c.head_vectors, dim)
        body[i], has_body[i] = _centroid(c.body_vectors, dim)
        types[i] = c.type
    return head, body, has_head, has_body, types


def build_card_image_matrix(cards: list[CardRecord], dim: int, which: str = "head"):
    """Per-image normalised embeddings padded to the largest card: ``(imgs (C,
    N, D), valid (C, N))``. The max strategy needs every image pair, so it does
    not reduce to centroids."""
    vec_lists = []
    for c in cards:
        v = c.head_vectors if which == "head" else c.body_vectors
        v = (np.asarray(v, np.float32).reshape(-1, dim) if v is not None and len(v)
             else np.zeros((0, dim), np.float32))
        vec_lists.append(v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-12))
    n_max = max((len(v) for v in vec_lists), default=1) or 1
    imgs = np.zeros((len(cards), n_max, dim), np.float32)
    valid = np.zeros((len(cards), n_max), bool)
    for i, v in enumerate(vec_lists):
        imgs[i, : len(v)] = v
        valid[i, : len(v)] = True
    return imgs, valid


@float32_matmuls()
def max_strategy_card_scores(q_imgs: np.ndarray, q_valid: np.ndarray, g_imgs: np.ndarray,
                             g_valid: np.ndarray, block: int = 512,
                             device: str | torch.device = "cuda") -> np.ndarray:
    """Max-strategy scores: the max over image pairs of ``(cos + 1) / 2``, no
    clamp at 0. Pairs with a missing image are left out; a card with no
    images scores ``-inf``. One product per block of ``block`` gallery cards."""
    dev = resolve_device(device)
    qm = torch.from_numpy(np.ascontiguousarray(q_imgs, np.float32)).to(dev)
    qv = torch.from_numpy(np.asarray(q_valid, bool)).to(dev)
    G = g_imgs.shape[0]
    out = np.full((q_imgs.shape[0], G), -np.inf, np.float32)
    for lo in range(0, G, block):
        gm = torch.from_numpy(np.ascontiguousarray(g_imgs[lo:lo + block], np.float32)).to(dev)
        gv = torch.from_numpy(np.asarray(g_valid[lo:lo + block], bool)).to(dev)
        s = (torch.einsum("qnd,gmd->qgnm", qm, gm) + 1.0) / 2.0
        mask = qv[:, None, :, None] & gv[None, :, None, :]
        s = torch.where(mask, s, torch.full_like(s, -math.inf)).amax(dim=(2, 3))
        out[:, lo:lo + gm.shape[0]] = s.cpu().numpy()
    return out


def max_strategy_cal_scores(v1, v2) -> float:
    """Two lists of image embeddings -> their max-pair score (the reference's
    signature)."""
    def norm_stack(v):
        arr = np.stack([np.asarray(x, np.float32).reshape(-1) for x in v])
        return arr / np.maximum(np.linalg.norm(arr, axis=-1, keepdims=True), 1e-12)

    a, b = norm_stack(v1), norm_stack(v2)
    return float(((a @ b.T + 1.0) / 2.0).max())


@float32_matmuls()
def pairwise_card_scores(q: np.ndarray, g: np.ndarray, device: str | torch.device = "cuda",
                         mesh: parallel.Mesh | None = None) -> np.ndarray:
    """``(Q, D) x (G, D) -> (Q, G)`` mean-strategy scores ``max(0, (q.g + 1) / 2)``,
    one ``torch.matmul`` on ``device`` in float32; under a mesh, of this
    process's gallery rows (the gallery zero-padded to split evenly), every
    rank's columns gathered in order."""
    dev = resolve_device(device)
    g = np.ascontiguousarray(g, np.float32)
    G = g.shape[0]
    if mesh is not None:
        padded = _pad_rows(g, mesh.size)
        g = padded[mesh.rows(len(padded))]
    qt = torch.from_numpy(np.ascontiguousarray(q, np.float32)).to(dev)
    gt = torch.from_numpy(g).to(dev)
    s = torch.clamp((torch.matmul(qt, gt.T) + 1.0) / 2.0, min=0.0)
    if mesh is not None:
        s = parallel.all_gather_rows(s.T, mesh).T[:, :G]
    return s.cpu().numpy()


def _pad_rows(x: np.ndarray, n: int) -> np.ndarray:
    pad = (-x.shape[0]) % n
    return np.concatenate([x, np.zeros((pad, *x.shape[1:]), x.dtype)]) if pad else x


def _stable_topk(s: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top ``k`` along the last axis, ties to the lower index (``lax.top_k``)."""
    order = torch.sort(s, dim=-1, descending=True, stable=True).indices[..., :k]
    return torch.gather(s, -1, order), order


@float32_matmuls()
def sharded_topk_scores(queries: np.ndarray, gallery: np.ndarray, k: int,
                        mesh: parallel.Mesh, axis: str = "data") -> tuple[np.ndarray, np.ndarray]:
    """Two-stage top-k of the mean-strategy scores over a gallery split over
    the mesh's ``data`` axis (zero-padded to split evenly): each rank scores
    its ``G / n`` rows on the mesh's device, its padded rows at ``-inf``,
    and keeps its top ``min(k, G / n)``; the ``(Q, kk)`` of every
    rank are gathered in order and the global top ``min(k, n kk)`` taken,
    ties to the lower gallery index. Returns ``(scores (Q, k), indices (Q,
    k))`` into the whole gallery."""
    if axis != "data":
        raise ValueError(f"axis {axis!r}: the port has only the 'data' axis")
    dev = mesh.device
    G = gallery.shape[0]
    padded = _pad_rows(np.ascontiguousarray(gallery, np.float32), mesh.size)
    shard_size = padded.shape[0] // mesh.size
    kk = min(k, shard_size)
    rows = mesh.rows(padded.shape[0])
    qt = torch.from_numpy(np.ascontiguousarray(queries, np.float32)).to(dev)
    gt = torch.from_numpy(padded[rows]).to(dev)
    s = torch.clamp((torch.matmul(qt, gt.T) + 1.0) / 2.0, min=0.0)
    index = torch.arange(rows.start, rows.stop, device=dev)
    s = torch.where((index < G)[None, :], s, torch.full_like(s, -math.inf))
    top_s, top_i = _stable_topk(s, kk)
    top_i = top_i + rows.start
    # (n Q, kk) in rank order -> (Q, n kk), shard by shard
    Q = qt.shape[0]
    all_s = parallel.all_gather_rows(top_s, mesh).reshape(mesh.size, Q, kk)
    all_i = parallel.all_gather_rows(top_i, mesh).reshape(mesh.size, Q, kk)
    all_s = all_s.permute(1, 0, 2).reshape(Q, -1)
    all_i = all_i.permute(1, 0, 2).reshape(Q, -1)
    final_s, pos = _stable_topk(all_s, min(k, all_s.shape[1]))
    return final_s.cpu().numpy(), torch.gather(all_i, 1, pos).cpu().numpy()


def ensemble_scores(head_scores: np.ndarray, body_scores: np.ndarray, q_has_head: np.ndarray,
                    g_has_head: np.ndarray, q_has_body: np.ndarray, g_has_body: np.ndarray,
                    animal_type: int) -> tuple[np.ndarray, np.ndarray]:
    """The reference's ensemble rule, vectorised: a head score where both cards
    have head vectors, a body score where both have body vectors; pairs where
    both are 0 are left out; the body score is used when the query has no head
    vectors, or when the head score is 0 and the body score exceeds the
    species' threshold. Returns ``(scores (Q, G), include (Q, G))``."""
    head_ok = q_has_head[:, None] & g_has_head[None, :]
    body_ok = q_has_body[:, None] & g_has_body[None, :]
    h = np.where(head_ok, head_scores, 0.0)
    b = np.where(body_ok, body_scores, 0.0)
    include = (h + b) != 0
    thr = ENSEMBLE_BODY_THRESHOLDS[animal_type - 1]
    use_body = (~q_has_head[:, None]) | ((h == 0) & (b > thr))
    return np.where(use_body, b, h), include


def topk_rows(scores: np.ndarray, include: np.ndarray, gallery_names: list[str],
              k: int = 100) -> list[tuple | None]:
    """Per query: stable descending order (ties to the lower gallery index),
    top ``k``, and ``(top1, mean of the top min(n, 3), mean of the top
    min(n, 10), "name,name,...")``; ``None`` for a query with nothing
    included."""
    rows = []
    for s, inc in zip(scores, include):
        idx = np.nonzero(inc)[0]
        if len(idx) == 0:
            rows.append(None)
            continue
        order = idx[np.argsort(-s[idx], kind="stable")]
        top_scores = s[order]
        rows.append((
            float(top_scores[0]),
            float(np.mean(top_scores[: min(3, len(top_scores))])),
            float(np.mean(top_scores[: min(10, len(top_scores))])),
            ",".join(gallery_names[i] for i in order[: min(k, len(order))]),
        ))
    return rows


def infer_dim(cards: Iterable[CardRecord], default: int = 512) -> int:
    for c in cards:
        if c.has_head:
            return c.head_vectors.shape[-1]
        if c.has_body:
            return c.body_vectors.shape[-1]
    return default


def calc_scores(init_cards: list[CardRecord], extra_cards: list[CardRecord],
                device: str | torch.device = "cuda", dim: int | None = None, k: int = 100,
                dump: dict | None = None, mesh: parallel.Mesh | None = None) -> list[tuple]:
    """Score the query cards ``init_cards`` against the gallery ``extra_cards``
    of the same animal type; rows ``(query, matched_1, matched_3, matched_10,
    answer)`` in ``init_cards`` order, queries with nothing scored left out.
    ``dump``, when given, receives each scored type's rows (see the module
    docstring); ``mesh`` splits each gallery over its ranks."""
    if dim is None:
        dim = infer_dim(list(init_cards) + list(extra_cards))
    rows_by_pos: dict[int, tuple] = {}
    for animal_type in sorted({c.type for c in init_cards}):
        q_pos = [i for i, c in enumerate(init_cards) if c.type == animal_type]
        q_cards = [init_cards[i] for i in q_pos]
        g_cards = [c for c in extra_cards if c.type == animal_type]
        if not g_cards:
            continue
        qh, qb, qhh, qhb, _ = build_card_matrix(q_cards, dim)
        gh, gb, ghh, ghb, _ = build_card_matrix(g_cards, dim)
        scores, include = ensemble_scores(
            pairwise_card_scores(qh, gh, device, mesh), pairwise_card_scores(qb, gb, device, mesh),
            qhh, ghh, qhb, ghb, animal_type)
        g_names = [c.name for c in g_cards]
        if dump is not None:
            for qi, c in enumerate(q_cards):
                dump[c.name] = {"gallery": np.array(g_names),
                                "scores": np.asarray(scores[qi], np.float32),
                                "include": np.asarray(include[qi], bool)}
        for pos, c, row in zip(q_pos, q_cards, topk_rows(scores, include, g_names, k)):
            if row is not None:
                rows_by_pos[pos] = (c.name, *row)
    return [rows_by_pos[i] for i in sorted(rows_by_pos)]


def create_table(db: Mapping[object, tuple[list[CardRecord], list[CardRecord]]],
                 device: str | torch.device = "cuda", dump: dict | None = None,
                 mesh: parallel.Mesh | None = None) -> list[tuple]:
    """The rows of every ``(queries, gallery)`` pair of ``db``, in its order."""
    rows = []
    for init_cards, extra_cards in db.values():
        rows.extend(calc_scores(init_cards, extra_cards, device, dump=dump, mesh=mesh))
    return rows


_POW10 = [float(f"1e{k}") for k in range(309)]
_NUMBER = re.compile(r"\s*([+-]?)(\d*)(?:\.(\d*))?(?:[eE]([+-]?\d+))?\s*$")


def _read_float(text: str) -> float:
    """``text`` as pandas' default float parser reads it (``precise_xstrtod``
    of its C tokenizer): at most 17 digits, a leading zero included, are
    accumulated as ``n * 10 + d`` and scaled by one power of ten, so the result
    is not always the correctly rounded ``float(text)``."""
    m = _NUMBER.match(text)
    if not m or not (m.group(2) or m.group(3)):
        raise ValueError(f"not a number: {text!r}")
    sign, int_part, frac_part, exp_part = m.groups()
    number, exponent, n_digits = 0.0, 0, 0
    for ch in int_part:
        if n_digits < 17:
            number = number * 10.0 + int(ch)
            n_digits += 1
        else:
            exponent += 1
    n_decimals = 0
    for ch in (frac_part or "")[: max(17 - n_digits, 0)]:
        number = number * 10.0 + int(ch)
        n_decimals += 1
    exponent += int(exp_part or 0) - n_decimals
    if sign == "-":
        number = -number
    if exponent > 308:
        return math.copysign(math.inf, number)
    if exponent > 0:
        return number * _POW10[exponent]
    if exponent < -308:
        return 0.0 * number if exponent < -616 else number / _POW10[-308 - exponent] / _POW10[308]
    return number / _POW10[-exponent]


def _read_tsv(path: str | Path) -> list[tuple]:
    """A tsv with :data:`COLUMNS` as pandas' ``read_csv(sep="\\t")`` reads it:
    numbers become floats (:func:`_read_float`), empty cells ``None``."""
    with open(path, newline="") as f:
        reader = csv.reader(f, delimiter="\t")
        header = next(reader)
        if tuple(header) != COLUMNS:
            raise ValueError(f"{path}: header {header}, expected {list(COLUMNS)}")
        rows = []
        for cells in reader:
            row = dict(zip(COLUMNS, cells))
            rows.append(tuple(
                None if row.get(c, "") == "" else _read_float(row[c]) if c in NUMERIC_COLUMNS
                else row[c] for c in COLUMNS))
    return rows


def backfill_missing(rows: list[tuple], stock_tsv: str | Path) -> list[tuple]:
    """Append the rows of a stock predictions tsv whose query has no row yet."""
    have = {r[0] for r in rows}
    return list(rows) + [r for r in _read_tsv(stock_tsv) if r[0] not in have]


def write_tsv(rows: list[tuple], path: str | Path) -> None:
    """Write ``rows`` under the :data:`COLUMNS` header, tab-separated, floats as
    ``repr``, ``None`` as an empty cell: the bytes of pandas'
    ``DataFrame.to_csv(path, sep="\\t", index=False)``."""
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, delimiter="\t", lineterminator="\n")
        writer.writerow(COLUMNS)
        writer.writerows(rows)


def write_scores_dump(dump: Mapping[str, Mapping], path: str | Path) -> Path:
    """Save a :func:`calc_scores` dump as an npz with the JAX package's keys."""
    arrays = {f"{q}/{field}": d[field] for q, d in dump.items()
              for field in ("gallery", "scores", "include")}
    out = Path(path)
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(out, **arrays)
    return out


def flush_scores_dump(dump: Mapping[str, Mapping], path: str | Path | None = None
                      ) -> Path | None:
    """Write ``dump`` to ``path`` or else ``PFR_SCORES_DUMP`` and say so;
    nothing (``None``) without a path or without a row."""
    path = path or os.environ.get("PFR_SCORES_DUMP")
    if not path or not dump:
        return None
    out = write_scores_dump(dump, path)
    print(f"scores dump: {len(dump)} queries -> {out}")
    return out


def load_scores_dump(path: str | Path) -> dict[str, dict]:
    with np.load(path, allow_pickle=False) as z:
        out: dict[str, dict] = {}
        for key in z.files:
            q, field = key.rsplit("/", 1)
            out.setdefault(q, {})[field] = z[key]
    return out


def near_tie_report(a: Mapping[str, Mapping], b: Mapping[str, Mapping]) -> dict:
    """Compare two score dumps: the largest score drift over the queries and
    gallery cards both hold, and the largest ``a``-score gap across which the
    two rank orders invert a pair (``tools/verify_near_tie_contract.py``'s
    contract: rank flips only across gaps below the drift budget). Queries and
    gallery cards that only one dump holds are listed."""
    shared = sorted(set(a) & set(b))
    report = {"queries_a": len(a), "queries_b": len(b), "only_a": sorted(set(a) - set(b)),
              "only_b": sorted(set(b) - set(a)), "n_shared": len(shared)}
    max_drift = max_flip_gap = 0.0
    worst_flip = None
    n_flipped_pairs = n_queries_with_flips = 0
    gal_only_a: set = set()
    gal_only_b: set = set()
    for q in shared:
        ga = [str(x) for x in a[q]["gallery"]]
        gb = [str(x) for x in b[q]["gallery"]]
        common = sorted(set(ga) & set(gb))
        gal_only_a |= set(ga) - set(gb)
        gal_only_b |= set(gb) - set(ga)
        if not common:
            continue
        ia = [ga.index(n) for n in common]
        ib = [gb.index(n) for n in common]
        idx = np.nonzero(a[q]["include"][ia] & b[q]["include"][ib])[0]
        if len(idx) == 0:
            continue
        s_a = a[q]["scores"][ia][idx].astype(np.float64)
        s_b = b[q]["scores"][ib][idx].astype(np.float64)
        max_drift = max(max_drift, float(np.abs(s_a - s_b).max()))
        n = len(idx)
        pos_a = np.empty(n, np.int64)
        pos_a[np.argsort(-s_a, kind="stable")] = np.arange(n)
        pos_b = np.empty(n, np.int64)
        pos_b[np.argsort(-s_b, kind="stable")] = np.arange(n)
        iu = np.triu_indices(n, 1)
        inverted = ((pos_a[:, None] - pos_a[None, :]) * (pos_b[:, None] - pos_b[None, :]) < 0)[iu]
        if not inverted.any():
            continue
        n_queries_with_flips += 1
        n_flipped_pairs += int(inverted.sum())
        gaps = np.abs(s_a[iu[0][inverted]] - s_a[iu[1][inverted]])
        if float(gaps.max()) > max_flip_gap:
            max_flip_gap = float(gaps.max())
            w = int(np.argmax(gaps))
            worst_flip = {"query": q, "card_a": common[idx[iu[0][inverted][w]]],
                          "card_b": common[idx[iu[1][inverted][w]]], "float_gap": max_flip_gap}
    report.update(gallery_only_a=sorted(gal_only_a), gallery_only_b=sorted(gal_only_b),
                  max_score_drift=max_drift, n_flipped_pairs=n_flipped_pairs,
                  n_queries_with_flips=n_queries_with_flips, max_flip_float_gap=max_flip_gap,
                  worst_flip=worst_flip)
    return report
