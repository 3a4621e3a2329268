"""JAX's linear scale_and_translate and resize in the port
(tell_tpu_torch/ops/image_resize.py) against jax.image, as tell_tpu's
MTCNN pyramid and crop_and_resize call it, on the CPU.

Tolerances: the weight matrices within 1e-5 absolute (weights below 1,
from sample positions of up to a few hundred pixels whose fp32 rounding,
~2.5e-5 at 416, XLA's fused jit order changes); the resampled images
within 1e-5 relative to their largest value (two matrix products summed in
another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.image.scale import _fill_triangle_kernel, compute_weight_mat

from tell_tpu.models.backbones.yolov3 import crop_and_resize as j_crop
from tell_tpu_torch.models.backbones.yolov3 import crop_and_resize
from tell_tpu_torch.ops.image_resize import (resize_linear,
                                             scale_and_translate,
                                             weight_matrix)

REL = 1e-5


def _rel_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("m,n,scale,translation", [
    (50, 24, 24 / 50, 0.0), (24, 50, 50 / 24, 0.0), (416, 24, 0.7, -3.5),
    (60, 48, 1e6, -2e7), (60, 48, 2.0, 150.0), (30, 160, 3.3, -11.25),
    (7, 7, 1.0, 0.0)])
def test_weight_matrix_equals_jax(m, n, scale, translation):
    want = jax.jit(lambda s, t: compute_weight_mat(
        m, n, s, t, _fill_triangle_kernel, True))(jnp.float32(scale),
                                                  jnp.float32(translation))
    got = weight_matrix(m, n, torch.tensor(scale), torch.tensor(translation))
    assert got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("out_h,out_w", [(30, 41), (50, 70), (77, 90),
                                         (12, 13), (50, 19), (250, 250)])
def test_resize_linear_equals_jax_image_resize(out_h, out_w):
    """The pyramid's resize of the normalised canvas, shrink and enlarge,
    one axis kept."""
    img = np.random.default_rng(out_h * out_w).uniform(
        -1, 1, (50, 70, 3)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(img), (out_h, out_w, 3), "linear",
                            antialias=True)
    got = resize_linear(torch.from_numpy(img), out_h, out_w)
    assert got.shape == (out_h, out_w, 3)
    assert _rel_err(got, want) <= REL


def test_crop_and_resize_equals_jax_with_degenerate_boxes():
    """Boxes inside, across the edges, empty, inverted, sub-pixel and far
    outside: finite everywhere, each crop JAX's."""
    img = np.random.default_rng(1).uniform(0, 255, (50, 70, 3)).astype(
        np.float32)
    boxes = np.array([[3, 4, 40, 30], [0, 0, 0, 0], [10, 10, 9, 12],
                      [-5, -3, 80, 60], [20.5, 7.25, 22.1, 9.9],
                      [1e5, 1e5, 2e5, 2e5], [69, 49, 70, 50],
                      [30, 30, 30, 45]], np.float32)
    crop = jax.jit(j_crop, static_argnums=2)
    for size in (24, 48, 160):
        want = np.asarray(crop(jnp.asarray(img), jnp.asarray(boxes), size))
        got = crop_and_resize(torch.from_numpy(img), torch.from_numpy(boxes),
                              size).numpy()
        assert got.shape == (len(boxes), size, size, 3)
        assert np.isfinite(got).all()
        assert _rel_err(got, want) <= REL
    # the empty box samples one pixel row / column: never NaN, never inf
    assert np.isfinite(crop_and_resize(torch.from_numpy(img),
                                       torch.zeros(3, 4), 24).numpy()).all()


def test_scale_and_translate_rows_are_independent():
    """Batched over boxes, each crop equals the crop of its box alone, bit
    for bit (the weights of one box never reach another's row)."""
    img = torch.from_numpy(np.random.default_rng(2).uniform(
        0, 255, (40, 30, 3)).astype(np.float32))
    scale = torch.tensor([[0.5, 0.7], [1e6, 1e6], [2.0, 3.0]])
    trans = torch.tensor([[-1.0, 2.0], [-3e6, 0.0], [5.0, -7.5]])
    all_rows = scale_and_translate(img, 16, 12, scale, trans)
    for i in range(3):
        one = scale_and_translate(img, 16, 12, scale[i:i + 1],
                                  trans[i:i + 1])
        assert torch.equal(all_rows[i], one[0])
