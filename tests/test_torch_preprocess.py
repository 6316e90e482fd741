"""The port's preprocess and anchors against the goldens and the JAX package."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from headpose_tpu.ops.image import preprocess as jax_preprocess
from headpose_tpu.ops.image import resize_bicubic as jax_resize
from headpose_tpu_torch.models.anchors import BACK_CONFIG, generate_anchors
from headpose_tpu_torch.ops.image import preprocess, resize_bicubic

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


@pytest.mark.parametrize("i", [0, 1, 2])
def test_resize_matches_tf_golden(i):
    """TF-exact bicubic (tests/golden/resize_bicubic.npz).  Tolerance 4e-7
    (3 ulp at 1.0): the JAX reference itself is 3.58e-7 off on image 1, the
    same as the port, above the 3.3e-7 its docstring states; the port must
    also stay within 1e-6 of the JAX resize."""
    g = np.load(os.path.join(GOLDEN, "resize_bicubic.npz"))
    out = resize_bicubic(torch.from_numpy(g[f"img{i}"]), (128, 128)).numpy()
    np.testing.assert_allclose(out, g[f"resized{i}"], rtol=0, atol=4e-7)
    ref = np.asarray(jax_resize(jnp.asarray(g[f"img{i}"]), (128, 128)))
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("hw", [(128, 128), (77, 99), (240, 320)])
@pytest.mark.parametrize("order", ["bgr", "rgb"])
def test_preprocess_matches_jax(hw, order):
    """Random uint8 frames, 128 being the same-size short-circuit; atol 1e-6
    (two fp32 matmuls summed in another order)."""
    rng = np.random.default_rng(hw[0] * 1000 + hw[1])
    img = rng.integers(0, 256, (2, *hw, 3), dtype=np.uint8)
    got = preprocess(torch.from_numpy(img), 128, order).numpy()
    want = np.asarray(jax_preprocess(jnp.asarray(img), 128, order))
    assert got.shape == (2, 128, 128, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_single_image_and_same_size_promotion():
    img = np.random.default_rng(0).integers(0, 256, (128, 128, 3),
                                            dtype=np.uint8)
    out = resize_bicubic(torch.from_numpy(img), (128, 128))
    assert out.dtype == torch.float32 and out.shape == (128, 128, 3)
    x = preprocess(torch.from_numpy(img))
    assert x.shape == (128, 128, 3)


def test_channel_order_validated():
    with pytest.raises(ValueError, match="channel_order"):
        preprocess(torch.zeros((4, 4, 3)), channel_order="bgra")


@pytest.mark.parametrize("cfg,name", [(None, "anchors.npz"),
                                      (BACK_CONFIG, "anchors_back.npz")])
def test_anchors_equal_goldens(cfg, name):
    want = np.load(os.path.join(GOLDEN, name))["anchors"]
    got = generate_anchors() if cfg is None else generate_anchors(cfg)
    np.testing.assert_array_equal(got, want)
