"""The port's grid detectors at the full width of ``WEAK`` and ``STRONG``
against ``repro``'s, with the JAX weights carried over, on 16 seeded
``ShapesDataset`` images."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models import detector as jdet
from repro_torch.convert import detector_params_from_jax
from repro_torch.data.shapes import ShapesDataset
from repro_torch.models import detector as tdet

CONFIGS = {"weak": (jdet.WEAK, tdet.WEAK), "strong": (jdet.STRONG, tdet.STRONG)}


@pytest.fixture(scope="module")
def images():
    return ShapesDataset.generate(16, seed=3).images


_INIT = jax.jit(jdet.detector_init, static_argnums=1)
_PARAMS = {}


def _pair(name, seed=0):
    jcfg, tcfg = CONFIGS[name]
    if (name, seed) not in _PARAMS:
        _PARAMS[name, seed] = _INIT(jax.random.PRNGKey(seed), jcfg)
    params = _PARAMS[name, seed]
    det = tdet.Detector(tcfg, device="cpu")
    det.load_state_dict(detector_params_from_jax(jax.tree.map(np.asarray, params)))
    return jcfg, params, det


def test_configs_match():
    for jcfg, tcfg in CONFIGS.values():
        assert (jcfg.widths, jcfg.head_width, jcfg.num_classes, jcfg.image_size, jcfg.grid) == (
            tcfg.widths, tcfg.head_width, tcfg.num_classes, tcfg.image_size, tcfg.grid)


@pytest.mark.parametrize("name", ["weak", "strong"])
def test_detector_head_matches(name, images):
    jcfg, params, det = _pair(name)
    j_out, j_feat = jax.jit(jdet.detector_apply, static_argnums=1)(
        params, jcfg, jnp.asarray(images))
    t_out, t_feat = tdet.detector_apply(det, images)
    G = jcfg.grid
    assert t_out.shape == (16, G, G, 1 + jcfg.num_classes + 4)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=1e-5, rtol=0)
    np.testing.assert_allclose(t_feat.numpy(), np.asarray(j_feat), atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", ["weak", "strong"])
def test_decoded_detections_match(name, images):
    jcfg, params, det = _pair(name)
    jb, js, jc, _ = jdet.detector_forward(params, jcfg, jnp.asarray(images))
    tb, ts, tc, _ = tdet.detector_forward(det, images)
    # boxes are in pixels (up to 64x the head's scale): compare them as
    # image fractions, the scale the head predicts them at
    size = jcfg.image_size
    np.testing.assert_allclose(tb.numpy() / size, np.asarray(jb) / size, atol=1e-5, rtol=0)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert tc.dtype == torch.int32


def test_same_padding_rule():
    # JAX's SAME: stride 2 on an even size pads the odd pixel after only
    assert tdet._same_pad(64, 3, 2) == (0, 1)
    assert tdet._same_pad(8, 3, 2) == (0, 1)
    assert tdet._same_pad(63, 3, 2) == (1, 1)
    assert tdet._same_pad(64, 3, 1) == (1, 1)
    assert tdet._same_pad(8, 1, 1) == (0, 0)


def test_symmetric_padding_would_differ(images):
    """The asymmetric pad is load-bearing: Conv2d(padding=1) on the first
    stride-2 stage gives a different map."""
    jcfg, params, det = _pair("weak")
    x = torch.tensor(images).permute(0, 3, 1, 2)
    conv = det.stage0_a
    ours = conv(torch.nn.functional.pad(x, (0, 1, 0, 1)))
    symmetric = torch.nn.functional.conv2d(x, conv.weight, conv.bias, stride=2, padding=1)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(images), params["stage0_a"]["w"], (2, 2), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC")) + params["stage0_a"]["b"]
    want = np.asarray(want).transpose(0, 3, 1, 2)
    np.testing.assert_allclose(ours.detach().numpy(), want, atol=1e-5)
    assert np.abs(symmetric.detach().numpy() - want).max() > 1e-2


def test_converted_state_layout():
    tree = jax.tree.map(np.asarray, _pair("weak")[1])
    state = detector_params_from_jax(tree)
    assert state["stage0_a.weight"].shape == (12, 3, 3, 3)
    np.testing.assert_array_equal(
        state["stage1_b.weight"].numpy(), tree["stage1_b"]["w"].transpose(3, 2, 0, 1)
    )
    assert set(state) == set(tdet.Detector(tdet.WEAK, device="cpu").state_dict())
