"""The port's 2D L1 distance transform and signed distance fields vs the
JAX package, bit for bit: every value is a small integer, FLT_MAX, or
one single-rounded multiply by 1/abs_max (or by sdf_scale)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vacancy_tpu.ops import sdf2d as jsdf
from vacancy_tpu_torch.ops import sdf2d as tsdf


def _masks(seed, n=3, h=24, w=32, degenerate=True):
    """Blobby uint8 masks: random discs, plus (``degenerate``) one
    all-foreground and one all-background image, whose distance
    transforms stay at FLT_MAX."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for _ in range(n):
        m = np.zeros((h, w), bool)
        for _ in range(3):
            cy, cx = rng.uniform(0, h), rng.uniform(0, w)
            r = rng.uniform(2, 9)
            m |= (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
        out.append(m)
    if degenerate:
        out += [np.ones((h, w), bool), np.zeros((h, w), bool)]
    return (np.stack(out).astype(np.uint8) * 255)


ROIS = [None, (3, 2, 27, 20)]


@pytest.mark.parametrize("roi", ROIS, ids=["full", "roi"])
@pytest.mark.parametrize("seed", [0, 1])
def test_distance_transform_bitwise(seed, roi):
    masks = _masks(seed)
    t = tsdf.distance_transform_l1(torch.from_numpy(masks), roi)
    for i, m in enumerate(masks):
        j = np.asarray(jsdf.distance_transform_l1(jnp.asarray(m), roi))
        np.testing.assert_array_equal(t[i].numpy(), j)
    # bool masks take the same path as uint8 == 255
    tb = tsdf.distance_transform_l1(torch.from_numpy(masks == 255), roi)
    np.testing.assert_array_equal(tb.numpy(), t.numpy())


SDF_CASES = [
    dict(),
    dict(minmax_normalize=False),
    dict(use_truncation=True, truncation_band=0.1),
    dict(use_truncation=True, truncation_band=0.05),
    dict(sdf_scale=0.013),
    dict(sdf_scale=0.013, use_truncation=True, truncation_band=0.05),
]


@pytest.mark.parametrize("roi", ROIS, ids=["full", "roi"])
@pytest.mark.parametrize(
    "kw", SDF_CASES,
    ids=["minmax", "raw", "trunc0.1", "trunc0.05", "scale", "scale-trunc"],
)
def test_signed_distance_field_bitwise(kw, roi):
    masks = _masks(7, n=4, degenerate=False)
    t = tsdf.make_signed_distance_field(torch.from_numpy(masks), roi, **kw)
    j = jax.vmap(lambda m: jsdf.make_signed_distance_field(m, roi, **kw))(
        jnp.asarray(masks)
    )
    assert t.dtype == torch.float32
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    # one image at a time gives the same bits as the batch
    t0 = tsdf.make_signed_distance_field(torch.from_numpy(masks[0]), roi, **kw)
    np.testing.assert_array_equal(t0.numpy(), t[0].numpy())


def test_signed_distance_field_degenerate_images():
    """An all-foreground (all-background) image has |sdf| = FLT_MAX, so
    the normalization multiplies by 1/FLT_MAX, a denormal. The port keeps
    IEEE denormals (as the reference C++ does) and gives -+0.99999994;
    XLA on the CPU flushes the denormal to zero and gives -+0. Everything
    else about these images agrees."""
    masks = _masks(0, n=0)
    t = tsdf.make_signed_distance_field(torch.from_numpy(masks)).numpy()
    below_one = np.float32(1.0) - np.float32(2.0) ** -24
    np.testing.assert_array_equal(t[0], np.full_like(t[0], -below_one))
    np.testing.assert_array_equal(t[1], np.full_like(t[1], below_one))
    j = jax.vmap(jsdf.make_signed_distance_field)(jnp.asarray(masks))
    np.testing.assert_array_equal(np.abs(np.asarray(j)), 0.0)
    # without normalization the two agree bit for bit (+-FLT_MAX)
    t = tsdf.make_signed_distance_field(
        torch.from_numpy(masks), minmax_normalize=False
    )
    j = jax.vmap(
        lambda m: jsdf.make_signed_distance_field(m, minmax_normalize=False)
    )(jnp.asarray(masks))
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
