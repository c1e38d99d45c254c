"""Compare two retrieval tsvs rank for rank (counterpart of the JAX
``tools/diff_tsv_ranks.py``).

A tsv is ``query, matched_1, matched_3, matched_10, answer``, where
``answer`` is the comma-joined top-100 gallery list, so comparing it compares
the whole ranking. The report has JAX's keys and values: the query sets
(and, where they differ, what is only in each and how many shared queries
are compared), the queries whose lists differ, each one's first divergent
rank, the top-1 and top-10 set changes, and the largest score delta of each
``matched_*`` column. The files are read as pandas reads them
(``retrieval.read_tsv``): an empty answer reads as ``"nan"``, and a column's
delta skips empty cells.

    python -m pets_face_recognition_tpu_torch.diff_tsv_ranks a.tsv b.tsv [--score-tol 1e-3]

Prints each key of the report, then ``RANK-SAFE`` and exits 0 when the query
sets are equal, every list is identical and every score delta is within
``--score-tol`` (default 1e-6); else ``RANK-DIVERGED`` and exit 1.
"""

from __future__ import annotations

import argparse
import math
import sys

from .retrieval import COLUMNS, read_tsv

SCORE_COLUMNS = ("matched_1", "matched_3", "matched_10")


def read_rows(path: str) -> dict[str, dict]:
    """``query -> {column: value}`` of a tsv, in file order."""
    return {row[0]: dict(zip(COLUMNS, row)) for row in read_tsv(path)}


def ranked(row: dict) -> list[str]:
    """The answer list of a row (pandas' ``str`` of an empty cell, ``nan``,
    for none)."""
    answer = row["answer"]
    return ("nan" if answer is None else str(answer)).split(",")


def _max_abs_delta(a: dict, b: dict, queries: list[str], col: str) -> float:
    deltas = [abs(a[q][col] - b[q][col]) for q in queries
              if a[q][col] is not None and b[q][col] is not None]
    return max(deltas) if deltas else math.nan


def compare(path_a: str, path_b: str, score_tol: float = 1e-6) -> dict:
    a, b = read_rows(path_a), read_rows(path_b)
    report: dict = {"queries_a": len(a), "queries_b": len(b)}
    queries = sorted(a)
    if set(a) != set(b):
        # which queries kept a row and how the shared ones rank are two
        # contracts: report the first, then compare the shared queries
        shared = sorted(set(a) & set(b))
        report.update(query_set_equal=False, only_a=sorted(set(a) - set(b)),
                      only_b=sorted(set(b) - set(a)))
        if not shared:
            return report
        queries = shared
        report["n_shared_compared"] = len(shared)
    else:
        report["query_set_equal"] = True

    rank_mismatch, first_div, top10_set_diff, top1_diff = [], {}, [], []
    for q in queries:
        ra, rb = ranked(a[q]), ranked(b[q])
        if ra == rb:
            continue
        rank_mismatch.append(q)
        first_div[q] = next((i for i, (x, y) in enumerate(zip(ra, rb)) if x != y),
                            min(len(ra), len(rb)))
        if ra[:1] != rb[:1]:
            top1_diff.append(q)
        if set(ra[:10]) != set(rb[:10]):
            top10_set_diff.append(q)
    score_max_delta = {col: _max_abs_delta(a, b, queries, col) for col in SCORE_COLUMNS}
    report.update(
        rank_identical=not rank_mismatch,
        n_rank_mismatch=len(rank_mismatch),
        rank_mismatch_queries=rank_mismatch[:20],
        first_divergence_rank=dict(sorted(first_div.items())[:20]),
        n_top1_changed=len(top1_diff),
        n_top10_set_changed=len(top10_set_diff),
        score_max_delta=score_max_delta,
        score_within_tol=all(v <= score_tol for v in score_max_delta.values()),
    )
    return report


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tsv_a")
    ap.add_argument("tsv_b")
    ap.add_argument("--score-tol", type=float, default=1e-6,
                    help="largest |delta| allowed on matched_{1,3,10} (ranks must be identical)")
    args = ap.parse_args(argv)
    report = compare(args.tsv_a, args.tsv_b, args.score_tol)
    for k, v in report.items():
        print(f"{k}: {v}")
    ok = (report.get("query_set_equal") and report.get("rank_identical")
          and report.get("score_within_tol"))
    print("RANK-SAFE" if ok else "RANK-DIVERGED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
