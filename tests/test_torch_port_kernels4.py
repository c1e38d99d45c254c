"""Kernel K2's two-pass algorithm and the redesigned wrappers of K2 and K3, on
the CPU.

(a) The plain twins of K2's two passes (``nms_suppress_words``: 64-bit
suppression words in the kernel's layout; ``nms_sweep_words``: the chunked
greedy sweep over them) give the keep mask of the plain K2 and of the JAX
Pallas kernel in interpret mode, with duplicate boxes (ties), invalid boxes,
zero-area boxes and pairs whose union is 0, at sizes around the 64-box word.
(b) The words hold :func:`suppress_matrix` bit for bit where the sweep reads
them, the ragged last word included.
(c) The wrappers raise on what the kernels do not take: more boxes than the
sweep's shared memory holds, channels that are not a multiple of 4.
(d) ``profile_serving.nms_work`` counts the IoUs and columns that a greedy
sweep visits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pets_face_recognition_tpu.ops.pallas_nms import nms_keep_sorted_batch as j_nms_pallas
from pets_face_recognition_tpu_torch import kernels
from pets_face_recognition_tpu_torch.ops import nms, roi_align
from pets_face_recognition_tpu_torch.profile_serving import nms_work

torch.set_num_threads(1)


def _nms_case(seed: int, G: int, K: int):
    """``(G, K, 4)`` float32 boxes and a ``(G, K)`` validity mask: random boxes
    with every 5th a copy of the one before (a tie), every 7th of zero width,
    and every 11th with its successor the same zero-area point (union 0)."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 100, (G, K, 2))
    wh = rng.uniform(2, 50, (G, K, 2))
    b = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    b[:, 5::5] = b[:, 4:K - 1:5]
    b[:, 3::7, 2] = b[:, 3::7, 0]
    pt = np.array([40.0, 40.0, 40.0, 40.0], np.float32)
    b[:, 10::11] = pt
    b[:, 11::11] = pt
    valid = rng.uniform(size=(G, K)) > 0.15
    return b, valid


@pytest.mark.parametrize("thr", [0.5, 0.7])
@pytest.mark.parametrize("K", [1, 63, 64, 65, 130, 300])
def test_two_pass_twin_matches_plain_and_pallas(K, thr):
    b, valid = _nms_case(K, 3, K)
    want = nms.nms_keep_sorted_batch(torch.from_numpy(b), torch.from_numpy(valid), thr)
    got = nms.nms_keep_sorted_batch_two_pass(torch.from_numpy(b), torch.from_numpy(valid), thr)
    pallas = np.asarray(j_nms_pallas(jnp.asarray(b), jnp.asarray(valid), thr,
                                     interpret=True)) > 0
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(got.numpy(), pallas)
    assert 0 < int(got.sum()) < int(valid.sum()) or K == 1


@pytest.mark.parametrize("K", [65, 130])
def test_suppress_words_hold_the_suppress_matrix(K):
    b, _ = _nms_case(K + 1, 2, K)
    boxes = torch.from_numpy(b)
    words = nms.nms_suppress_words(boxes, 0.5)
    n = -(-K // 64)
    assert words.shape == (2, n, n, 64) and words.dtype == torch.int64
    sup = nms.suppress_matrix(boxes, 0.5)
    bit = torch.arange(64)
    for c in range(n):
        for w in range(c, n):
            rows = slice(c * 64, min(K, c * 64 + 64))
            cols = slice(w * 64, min(K, w * 64 + 64))
            decoded = ((words[:, c, w, :, None] >> bit) & 1).bool()
            t_rows = min(K, c * 64 + 64) - c * 64
            n_cols = min(K, w * 64 + 64) - w * 64
            np.testing.assert_array_equal(decoded[:, :t_rows, :n_cols].numpy(),
                                          sup[:, rows, cols].numpy())
            # bits past K name no box
            assert not decoded[:, :t_rows, n_cols:].any()


def test_wrappers_raise_on_what_the_kernels_do_not_take(monkeypatch):
    monkeypatch.setattr(kernels, "check_cuda_f32", lambda *a: None)
    meta = dict(device="meta")
    K = nms.NMS_MAX_K + 1
    assert 2 * (-(-nms.NMS_MAX_K // 64)) * 65 * 8 <= 232448 < 2 * (-(-K // 64)) * 65 * 8
    with pytest.raises(ValueError, match="K<="):
        nms.nms_keep_sorted_batch_cuda(torch.empty(1, K, 4, **meta),
                                       torch.empty(1, K, dtype=torch.bool, **meta), 0.7)
    with pytest.raises(ValueError, match="C % 4"):
        roi_align.multilevel_roi_align_cuda([torch.empty(1, 8, 8, 6, **meta)],
                                            torch.empty(3, 4, **meta),
                                            torch.zeros(3, dtype=torch.int32, **meta),
                                            (7, 7), (4,), min_level=2, max_level=2)


def test_nms_work_counts_what_a_greedy_sweep_visits():
    b, valid = _nms_case(5, 2, 90)
    boxes, v = torch.from_numpy(b), torch.from_numpy(valid)
    keep = nms.nms_keep_sorted_batch(boxes, v, 0.5)
    sup = nms.suppress_matrix(boxes, 0.5)
    for g in range(2):
        alive, ious, columns = v[g].clone(), 0, 0
        for i in range(90):
            if alive[i]:
                ious += int(alive[i + 1:].sum())
                columns += 90 - 1 - i
                alive &= ~sup[g, i]
        w = nms_work(boxes, v, keep, 0.5, chunk=1)
        assert (int(w["ious"][g]), int(w["columns"][g])) == (ious, columns)
        assert int(w["kept"][g]) == int(keep[g].sum())
        assert int(w["valid"][g]) == int(v[g].sum())
