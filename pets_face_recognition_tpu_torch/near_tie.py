"""The near-tie rank contract between two ``PFR_SCORES_DUMP`` files
(counterpart of the JAX package's ``tools/verify_near_tie_contract.py``).

A rank-identical tsv holds only where score gaps exceed the quantization
drift, so the contract between a float and an int8 run of the chain is:

1. the int8-vs-float score drift is bounded (``--drift-budget``);
2. every rank inversion between the two orderings happens across a float
   score gap below ``--flip-budget`` (near-ties only).

    python -m pets_face_recognition_tpu_torch.near_tie float.npz int8.npz \\
        --drift-budget 5e-4 --flip-budget 5e-4

Prints a JSON report; exits 0 iff both budgets hold on every shared query.
Queries or gallery cards present in only one dump are reported as
membership churn (detection and validity flips, judged by the caller).
"""

from __future__ import annotations

import argparse
import json
import sys

from .retrieval import load_scores_dump, near_tie_report


def check(dump_float: str, dump_int8: str, drift_budget: float = 5e-4,
          flip_budget: float = 5e-4) -> dict:
    """The report of :func:`retrieval.near_tie_report` with the budgets and
    the verdict (``contract``: ``NEAR-TIE-SAFE`` or ``VIOLATED``)."""
    report = near_tie_report(load_scores_dump(dump_float), load_scores_dump(dump_int8))
    report["drift_budget"] = drift_budget
    report["flip_budget"] = flip_budget
    ok = (report["max_score_drift"] <= drift_budget
          and report["max_flip_float_gap"] <= flip_budget)
    report["contract"] = "NEAR-TIE-SAFE" if ok else "VIOLATED"
    return report


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dump_float")
    ap.add_argument("dump_int8")
    ap.add_argument("--drift-budget", type=float, default=5e-4)
    ap.add_argument("--flip-budget", type=float, default=5e-4)
    args = ap.parse_args(argv)
    report = check(args.dump_float, args.dump_int8, args.drift_budget, args.flip_budget)
    print(json.dumps(report, indent=2))
    return 0 if report["contract"] == "NEAR-TIE-SAFE" else 1


if __name__ == "__main__":
    sys.exit(main())
