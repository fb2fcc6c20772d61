"""A CPU model of the 3xTF32 product in the Hopper lens kernels' f32
instantiations (``csrc/tf32_split.cuh``).

Each f32 operand v is split into ``hi``, v rounded to TF32 (11 significant
bits: add half the dropped unit to the bits, clear the low 13 mantissa
bits), and ``lo``, the exact residual ``v - hi`` rounded the same way; the
product is ``hi_x . hi_e + lo_x . hi_e + hi_x . lo_e`` in f32.  Here numpy
does the same bit arithmetic, and the model is held to float64 logits at
the main path's depth D 3584, where one TF32 product misses f32's
tolerance.  Inputs come from numpy seeds.
"""

import numpy as np
import pytest
import torch

from taboo_brittleness_tpu_torch.ops import lens_kernel

D = 3584
LOGIT_ATOL = 1e-5


def tf32(v: np.ndarray) -> np.ndarray:
    """``tf32::nearest`` of ``csrc/tf32_split.cuh``, on f32 arrays."""
    bits = np.asarray(v, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(v: np.ndarray):
    hi = tf32(v)
    return hi, tf32(v - hi)


def three_products(x: np.ndarray, e: np.ndarray) -> np.ndarray:
    """The kernels' product: three TF32 products in one f32 sum."""
    (xh, xl), (eh, el) = split(x), split(e)
    return (xh @ eh.T) + (xl @ eh.T) + (xh @ el.T)


def _inputs(seed: int, n: int = 8, v: int = 512):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, D)).astype(np.float32)
    e = (rng.normal(size=(v, D)) * D ** -0.5).astype(np.float32)
    return x, e


def _is_tf32(a: np.ndarray) -> bool:
    return bool((a.view(np.uint32) & np.uint32(0x1FFF) == 0).all())


@pytest.mark.parametrize("scale", [1.0, D ** -0.5, 1e-20, 1e20])
def test_hi_plus_lo_reconstructs_v(scale):
    """hi and lo are TF32 values; v - hi is exact in f32 (hi + (v - hi)
    gives v back bit for bit); lo, that residual rounded to TF32, is within
    2^-22 of v, and hi is within 2^-11."""
    rng = np.random.default_rng(0)
    v = (rng.normal(size=100_000) * scale).astype(np.float32)
    hi, lo = split(v)
    assert _is_tf32(hi) and _is_tf32(lo)
    residual = v - hi
    assert np.array_equal((hi + residual).view(np.uint32), v.view(np.uint32))
    assert (np.abs(residual) <= np.abs(v) * 2.0 ** -11).all()
    err = np.abs((hi.astype(np.float64) + lo) - v)
    assert (err <= np.abs(v).astype(np.float64) * 2.0 ** -22).all()


def test_split_rounds_to_nearest_ties_away():
    """The rounding: nearest, a tie away from zero, carries into the
    exponent, and 0 and powers of two are left as they are."""
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)            # TF32's step at 1
    vals = np.array([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2 ** -23,
                     np.float32(2.0) - 2 ** -23, 0.0, 4.0], np.float32)
    want = np.array([one + ulp, -(one + ulp), one, 2.0, 0.0, 4.0], np.float32)
    np.testing.assert_array_equal(tf32(vals), want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_three_products_hold_f32_accuracy_at_depth_3584(seed):
    """At D 3584 the three-product sum is within 1e-5 of float64 logits, as
    a plain f32 product is; one TF32 product (hi . hi) is not."""
    x, e = _inputs(seed)
    exact = x.astype(np.float64) @ e.astype(np.float64).T
    err3 = np.abs(three_products(x, e) - exact).max()
    err_f32 = np.abs((x @ e.T) - exact).max()
    err1 = np.abs((tf32(x) @ tf32(e).T) - exact).max()
    assert err3 <= LOGIT_ATOL
    assert err_f32 <= LOGIT_ATOL
    assert err1 > 10 * LOGIT_ATOL


def test_three_products_give_the_plain_readout():
    """The lens statistics of the model's logits (logsumexp, top-k) against
    the port's plain f32 version on the same inputs: within 1e-5, ids
    equal."""
    x, e = _inputs(3, n=6, v=1024)
    logits = torch.from_numpy(three_products(x, e))
    ref = lens_kernel.lens_stats_reference(torch.from_numpy(x),
                                           torch.from_numpy(e), 5, top_k=5)
    np.testing.assert_allclose(torch.logsumexp(logits, -1).numpy(),
                               ref.logsumexp.numpy(), rtol=0, atol=LOGIT_ATOL)
    vals, ids = lens_kernel.topk_lowest_id(logits, 5)
    np.testing.assert_allclose(vals.numpy(), ref.topk_vals.numpy(), rtol=0,
                               atol=LOGIT_ATOL)
    assert torch.equal(ids, ref.topk_ids)
