"""The port's image ops (`lmono_tpu_torch.ops.image`) against
`lmono_tpu.ops.image`, on the same numpy inputs.

Tolerances: pyramid levels and Scharr gradients within 1e-5 abs (3-tap
sums in f32, summed in another order); `bilinear_sample` within 1e-6 abs;
`max_pool_same` and the float→int rule exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmono_tpu.ops import image as jim
from lmono_tpu_torch.ops import image as tim

ATOL = 1e-5


def _image(seed, H=64, W=96):
    rng = np.random.default_rng(seed)
    return rng.random((H, W)).astype(np.float32)


@pytest.mark.parametrize("H,W,levels", [(64, 96, 3), (47, 155, 2), (33, 31, 3)])
def test_pyramid_and_gradients_match(H, W, levels):
    img = _image(H * W, H, W)
    jp = jim.build_pyramid(jnp.asarray(img), levels)
    tp = tim.build_pyramid(torch.from_numpy(img), levels)
    assert len(jp) == len(tp) == levels
    for a, b in zip(jp, tp):
        assert tuple(b.shape) == a.shape
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=ATOL)
        for ja, tb in zip(jim.scharr_gradients(a), tim.scharr_gradients(b)):
            np.testing.assert_allclose(tb.numpy(), np.asarray(ja), rtol=0, atol=ATOL)


def test_blur_and_pool_match():
    img = _image(1)
    np.testing.assert_allclose(tim.gauss_blur3(torch.from_numpy(img)).numpy(),
                               np.asarray(jim.gauss_blur3(jnp.asarray(img))),
                               rtol=0, atol=ATOL)
    img[5, :] = -np.inf
    np.testing.assert_array_equal(tim.max_pool_same(torch.from_numpy(img), 3).numpy(),
                                  np.asarray(jim.max_pool_same(jnp.asarray(img), 3)))


def test_bilinear_sample_matches_inside_outside_and_nan():
    img = _image(2)
    rng = np.random.default_rng(3)
    xy = (rng.random((200, 2)) * [130, 90] - [17, 13]).astype(np.float32)
    xy[:4] = [[np.nan, 5.0], [1e10, 3.0], [-1e10, np.inf], [95.0, 63.0]]
    a = np.asarray(jim.bilinear_sample(jnp.asarray(img), jnp.asarray(xy)))
    b = tim.bilinear_sample(torch.from_numpy(img), torch.from_numpy(xy)).numpy()
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-6, equal_nan=True)
    assert np.isnan(b[0]) and np.isfinite(b[1])


def test_float_to_int_follows_xla():
    x = np.array([np.nan, 1e10, -1e10, np.inf, -np.inf, 2.7, -2.7,
                  2147483520.0, -2147483648.0, 0.0], np.float32)
    want = np.asarray(jnp.asarray(x).astype(jnp.int32))
    assert want[:3].tolist() == [0, 2147483647, -2147483648]
    got = tim.to_int32_xla(torch.from_numpy(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
