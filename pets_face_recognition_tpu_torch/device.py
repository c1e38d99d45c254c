"""Device selection and float32 precision for the port's entry points.

Entry points default to ``device="cuda"`` and never fall back to the CPU on
their own: the CPU runs only when the caller asks for it, as the tests do.
They also run under :func:`float32_matmuls`, so that their parity with the JAX
package, which is stated in float32, holds whatever TF32 settings the caller
has; and so that a model computing in bfloat16 sums its products in float32,
as XLA does, whatever the caller allows cuBLAS (its bfloat16 reduced-precision
reductions are turned off inside).
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Return ``torch.device(device)``; raise if CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    return dev


def _switches() -> list[tuple[str, Callable, Callable, object]]:
    """``(name, get, set, float32 value)`` of every TF32 switch, in the order
    they are set and restored.

    The legacy pair (``cudnn.allow_tf32``, the float32 matmul precision) comes
    first: torch honours it in every release, and where torch also has
    per-operator ``fp32_precision`` settings its setters rewrite those. The
    per-operator settings then follow explicitly, so that a global
    ``torch.backends.fp32_precision = "tf32"`` is not inherited, and so that
    legacy and per-operator flags agree (torch raises when they disagree).
    """
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul

    def tolerant(get):
        # torch raises on reading a legacy flag once the caller has set the
        # per-operator ones to values it cannot express; those are restored
        # from the per-operator reads below, and the legacy flag is left as set
        def read():
            try:
                return get()
            except RuntimeError:
                return None
        return read

    def unless_none(set_):
        return lambda v: v is None or set_(v)

    switches = [
        ("cudnn.allow_tf32", tolerant(lambda: cudnn.allow_tf32),
         unless_none(lambda v: setattr(cudnn, "allow_tf32", v)), False),
        ("float32_matmul_precision", tolerant(torch.get_float32_matmul_precision),
         unless_none(torch.set_float32_matmul_precision), "highest"),
        # bfloat16 products summed in float32 (cuBLAS may otherwise reduce
        # split-K partial sums in bfloat16)
        ("cuda.matmul.allow_bf16_reduced_precision_reduction",
         lambda: matmul.allow_bf16_reduced_precision_reduction,
         lambda v: setattr(matmul, "allow_bf16_reduced_precision_reduction", v), False),
    ]
    per_op = [("cudnn.conv", getattr(cudnn, "conv", None)),
              ("cudnn.rnn", getattr(cudnn, "rnn", None)), ("cuda.matmul", matmul)]
    if all(hasattr(mod, "fp32_precision") for _, mod in per_op):
        switches += [(f"{name}.fp32_precision", lambda m=mod: m.fp32_precision,
                      lambda v, m=mod: setattr(m, "fp32_precision", v), "ieee")
                     for name, mod in per_op]
    return switches


def tf32_flags() -> dict[str, object]:
    """The current value of every switch :func:`float32_matmuls` sets, by name."""
    return {name: get() for name, get, _, _ in _switches()}


def float32_flags() -> dict[str, object]:
    """The values :func:`float32_matmuls` sets: TF32 off everywhere."""
    return {name: value for name, _, _, value in _switches()}


@contextlib.contextmanager
def float32_matmuls():
    """Turn TF32 off for cuDNN convolutions and CUDA matrix products, and
    cuBLAS's bfloat16 reduced-precision reductions, inside the block, and give
    the caller's settings back on exit, exceptions included.

    Usable as a decorator. Nesting is safe: each level restores what it found.
    """
    switches = _switches()
    saved = [(set_, get()) for _, get, set_, _ in switches]
    try:
        for _, _, set_, value in switches:
            set_(value)
        yield
    finally:
        for set_, value in saved:
            set_(value)
