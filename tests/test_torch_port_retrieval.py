"""The port's retrieval (``retrieval.py``) against the JAX package's on the CPU:
centroid scores, the ensemble rule, the stable top-k, the tsv bytes, the stock
backfill, the max strategy, the score dump and the near-tie report.

The synthetic DB is the tsv golden test's (``tests/test_tsv_golden.py``).
"""

import importlib
import sys
from pathlib import Path

import io

import numpy as np
import pandas as pd
import pytest
import torch

from pets_face_recognition_tpu import retrieval as jr
from pets_face_recognition_tpu_torch import retrieval as tr

from test_tsv_golden import GOLDEN, _synthetic_db

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
vntc = importlib.import_module("verify_near_tie_contract")

torch.set_num_threads(1)

# float32 products of 32-d centroids in another summation order than XLA's:
# scores agree to a few ulps of 1.0
SCORE_ATOL = 1e-6


def _port_db():
    """The golden DB as the port's ``CardRecord``s."""
    return {k: tuple([tr.CardRecord(c.name, c.type, c.head_vectors, c.body_vectors)
                      for c in cards] for cards in pair)
            for k, pair in _synthetic_db().items()}


@pytest.fixture(scope="module")
def tables():
    want = jr.create_table(_synthetic_db())
    got = tr.create_table(_port_db(), device="cpu")
    return want, got


def test_create_table_matches_jax(tables):
    """Identical ``query`` and ``answer`` columns; scores within SCORE_ATOL."""
    want, got = tables
    assert [r[0] for r in got] == list(want["query"])
    assert [r[4] for r in got] == list(want["answer"])
    for i, col in enumerate(tr.NUMERIC_COLUMNS, start=1):
        np.testing.assert_allclose([r[i] for r in got], want[col].to_numpy(), rtol=0,
                                   atol=SCORE_ATOL)


def test_write_tsv_bytes_match_the_golden(tables, tmp_path):
    """``write_tsv`` of the JAX rows is the golden file byte for byte, and of
    the port's own rows wherever their scores are the JAX ones bit for bit."""
    want, got = tables
    out = tmp_path / "jax_rows.tsv"
    tr.write_tsv(list(want.itertuples(index=False, name=None)), out)
    assert out.read_bytes() == GOLDEN.read_bytes()

    out = tmp_path / "port_rows.tsv"
    tr.write_tsv(got, out)
    golden_lines = GOLDEN.read_text().splitlines(keepends=True)
    lines = out.read_text().splitlines(keepends=True)
    assert lines[0] == golden_lines[0] == "query\tmatched_1\tmatched_3\tmatched_10\tanswer\n"
    same = [i for i, (g, w) in enumerate(zip(got, want.itertuples(index=False, name=None)))
            if g[1:4] == w[1:4]]
    assert len(same) >= len(got) // 2, f"only {len(same)} rows bit-equal"
    for i in same:
        assert lines[i + 1] == golden_lines[i + 1]


def test_backfill_missing_bytes_match_jax(tables, tmp_path):
    """A stock tsv with ``0.50``, integers, empty cells and queries already
    scored: the port writes what pandas' read/concat/to_csv writes."""
    want, got = tables
    stock = tmp_path / "stock.tsv"
    stock.write_text(
        "query\tmatched_1\tmatched_3\tmatched_10\tanswer\n"
        f"{want['query'][0]}\t0.1\t0.1\t0.1\tzz\n"
        "s1\t0.50\t0.250\t1\ta,b\n"
        "s2\t\t\t\t\n"
        "s3\t0.123456789012345678\t1e-05\t0.3\tc\n")
    want_path, got_path = tmp_path / "jax.tsv", tmp_path / "port.tsv"
    jr.write_tsv(jr.backfill_missing(want, stock), want_path)
    tr.write_tsv(tr.backfill_missing(list(want.itertuples(index=False, name=None)), stock),
                 got_path)
    assert got_path.read_bytes() == want_path.read_bytes()
    assert "s1\t0.5\t0.25\t1.0\ta,b\n" in got_path.read_text()
    assert "s2\t\t\t\t\n" in got_path.read_text()


def test_backfill_onto_no_rows(tmp_path):
    stock = tmp_path / "stock.tsv"
    stock.write_text("query\tmatched_1\tmatched_3\tmatched_10\tanswer\nq\t0.5\t0.5\t0.5\tx\n")
    rows = tr.backfill_missing([], stock)
    assert rows == [("q", 0.5, 0.5, 0.5, "x")]
    with pytest.raises(ValueError, match="header"):
        bad = tmp_path / "bad.tsv"
        bad.write_text("a\tb\n")
        tr.backfill_missing([], bad)


def test_pairwise_scores_match_jax():
    rng = np.random.RandomState(0)
    q = rng.randn(7, 64).astype(np.float32)
    g = rng.randn(11, 64).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    got = tr.pairwise_card_scores(q, g, device="cpu")
    np.testing.assert_allclose(got, jr.pairwise_card_scores(q, g), rtol=0, atol=SCORE_ATOL)
    assert got.dtype == np.float32 and (got >= 0).all()


@pytest.mark.parametrize("animal_type", [1, 2])
def test_ensemble_scores_match_jax(animal_type):
    """Head, body and the per-species body fallback, exactly."""
    rng = np.random.RandomState(animal_type)
    Q, G = 6, 9
    head = np.where(rng.rand(Q, G) < 0.3, 0.0, rng.rand(Q, G)).astype(np.float32)
    body = (0.85 + 0.15 * rng.rand(Q, G)).astype(np.float32)
    masks = [rng.rand(n) < 0.7 for n in (Q, G, Q, G)]
    got = tr.ensemble_scores(head, body, *masks, animal_type)
    want = jr.ensemble_scores(head, body, *masks, animal_type)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_topk_rows_ties_to_the_lower_index():
    scores = np.array([[0.5, 0.9, 0.5, 0.9, 0.1], [0.0, 0.0, 0.0, 0.0, 0.0]], np.float32)
    include = np.array([[True, True, True, True, False], [False] * 5])
    names = ["a", "b", "c", "d", "e"]
    got = tr.topk_rows(scores, include, names, k=3)
    assert got == jr.topk_rows(scores, include, names, k=3)
    assert got[0][3] == "b,d,a" and got[1] is None
    assert got[0][1] == float(np.mean(np.float32([0.9, 0.9, 0.5])))


def test_max_strategy_matches_jax():
    """Max over image pairs, no clamp, -inf for an empty card; blocks smaller
    than the gallery."""
    db = _port_db()
    q_cards, g_cards = db["found"]
    q_imgs, q_valid = tr.build_card_image_matrix(q_cards, 32)
    g_imgs, g_valid = tr.build_card_image_matrix(g_cards, 32, which="body")
    want_q = jr.build_card_image_matrix(_synthetic_db()["found"][0], 32)
    np.testing.assert_array_equal(q_imgs, want_q[0])
    np.testing.assert_array_equal(q_valid, want_q[1])
    got = tr.max_strategy_card_scores(q_imgs, q_valid, g_imgs, g_valid, block=8, device="cpu")
    want = jr.max_strategy_card_scores(q_imgs, q_valid, g_imgs, g_valid, block=8)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    assert (~fin).any() and fin.any()
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=SCORE_ATOL)
    with_heads = [c for c in q_cards if c.has_head]
    v1, v2 = list(with_heads[0].head_vectors), list(with_heads[1].head_vectors)
    assert tr.max_strategy_cal_scores(v1, v2) == pytest.approx(
        jr.max_strategy_cal_scores(v1, v2), abs=SCORE_ATOL)


def test_score_dump_keys_and_rows_match_jax(tmp_path, monkeypatch):
    """The dump's npz keys equal the JAX ``PFR_SCORES_DUMP`` keys; its rows
    agree within SCORE_ATOL; ``load_scores_dump`` reads either back."""
    want_path = tmp_path / "jax.npz"
    monkeypatch.setenv("PFR_SCORES_DUMP", str(want_path))
    jr._SCORES_DUMP.clear()
    try:
        jr.write_tsv(jr.create_table(_synthetic_db()), tmp_path / "jax.tsv")
    finally:
        jr._SCORES_DUMP.clear()
    dump = {}
    tr.create_table(_port_db(), device="cpu", dump=dump)
    got_path = tr.write_scores_dump(dump, tmp_path / "port.npz")
    with np.load(want_path) as w, np.load(got_path) as g:
        assert sorted(w.files) == sorted(g.files)
    got, want = tr.load_scores_dump(got_path), tr.load_scores_dump(want_path)
    for q in want:
        np.testing.assert_array_equal(got[q]["gallery"], want[q]["gallery"])
        np.testing.assert_array_equal(got[q]["include"], want[q]["include"])
        np.testing.assert_allclose(got[q]["scores"], want[q]["scores"], rtol=0, atol=SCORE_ATOL)


def test_near_tie_report_matches_the_tool():
    """The port's counterpart of ``tools/verify_near_tie_contract.py::compare``
    gives the tool's report on dumps with drift, flips and membership
    differences."""
    rng = np.random.RandomState(3)
    names = np.array([f"g{i}" for i in range(12)])
    a, b = {}, {}
    for qi in range(5):
        s = rng.rand(12).astype(np.float32)
        inc = rng.rand(12) < 0.8
        a[f"q{qi}"] = {"gallery": names, "scores": s, "include": inc}
        noisy = (s + rng.randn(12).astype(np.float32) * 0.05).astype(np.float32)
        b[f"q{qi}"] = {"gallery": names[1:], "scores": noisy[1:], "include": inc[1:]}
    b["q_only_b"] = a["q0"]
    got = tr.near_tie_report(a, b)
    want = vntc.compare(a, b)
    assert got == want
    assert got["n_flipped_pairs"] > 0 and got["gallery_only_a"] == ["g0"]


def test_stock_numbers_are_read_as_pandas_reads_them():
    """pandas' default parser keeps at most 17 digits (a leading zero counts)
    and is not correctly rounded; the port reads every number to the same
    double, on values written by ``repr`` and on hand-written ones."""
    rng = np.random.RandomState(7)
    texts = ([repr(float(np.float32(x))) for x in rng.rand(2000)]
             + [repr(float(x)) for x in rng.rand(2000)]
             + [repr(float(x)) for x in rng.randn(300) * 1e30]
             + [repr(float(x)) for x in rng.randn(300) * 1e-300]
             + ["0.50", "1", "-3.25e2", "1e-05", "0.123456789012345678", " 7.5 ", "1E3", ".5",
                "5.", "123456789012345678901"])
    want = pd.read_csv(io.StringIO("a\tb\n" + "".join(f"{t}\tx\n" for t in texts)),
                       sep="\t")["a"].tolist()
    got = [tr._read_float(t) for t in texts]
    assert got == want
    assert sum(g != float(t) for g, t in zip(got, texts)) > 0
