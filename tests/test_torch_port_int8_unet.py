"""The port's int8 UNet (cwfa_tpu_torch.models.unet) against the JAX
package's (cwfa_tpu.models.unet unet_calibrate / quantize_unet /
unet_quantized) at depth 3 with narrow widths, in f32, same weights.

Calibration and packing: scales within rtol 1e-6 (the f32 convs that feed
each site sum in another order in XLA and PyTorch).  A scale one ulp off
moves the folded weight w * s_in across a round() boundary now and then, so
the int8 weights may differ by +-1 in at most 0.1% of a site's entries.

Forward, with JAX's packs carried across (load_jax_unet_pack): the integer
sums are exact on both sides and the epilogues round alike, so the outputs
agree to the f32 parity bound of test_torch_port_layers.py, max|d| <= 1e-4
* max|ref| (they agree to the bit at this seed).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cwfa_tpu.models.unet import (UNetSpec as JUNetSpec, init_unet,
                                  quantize_unet as jquantize_unet,
                                  unet_calibrate as junet_calibrate,
                                  unet_quantized as junet_quantized)

from cwfa_tpu_torch.engine.jax_params import load_jax_params, load_jax_unet_pack
from cwfa_tpu_torch.models import unet as tunet

from test_torch_port_layers import randomize_fixed_leaves


def _spec(cls):
    return cls(in_channels=3, n_classes=3, depth=3, wf=3, batch_norm=True,
               use_bias=True, skip_conn=True)


@pytest.fixture(scope="module")
def unets():
    params, state = init_unet(jax.random.PRNGKey(5), _spec(JUNetSpec))
    rng = np.random.RandomState(1)
    params = randomize_fixed_leaves(params, rng)
    state = randomize_fixed_leaves(state, rng)
    module = tunet.UNet(_spec(tunet.UNetSpec)).eval()
    load_jax_params(module, params, state)
    x = rng.randn(2, 3, 16, 16).astype(np.float32)
    jp = jax.tree_util.tree_map(jnp.asarray, (params, state))
    scales = junet_calibrate(_spec(JUNetSpec), *jp, jnp.asarray(x))
    qpack = jquantize_unet(_spec(JUNetSpec), jp[0], scales)
    want = np.asarray(junet_quantized(_spec(JUNetSpec), *jp, jnp.asarray(x),
                                      qpack, scales)[0])
    jpack = jax.tree_util.tree_map(np.asarray,
                                   {"qpack": qpack, "scales": scales})
    return module, x, jpack, want


def test_unet_calibration_and_pack_match_jax(unets):
    module, x, jpack, _ = unets
    scales = tunet.unet_calibrate(module, torch.from_numpy(x))
    assert set(scales) == set(jpack["scales"])
    for site, s in scales.items():
        np.testing.assert_allclose(s.numpy(), jpack["scales"][site],
                                   rtol=1e-6, err_msg=str(site))
    packs = tunet.quantize_unet(module, scales)
    for site, pk in packs.items():
        d = np.abs(pk["wq"].numpy().astype(np.int32)
                   - jpack["qpack"][site]["wq"].astype(np.int32))
        assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (site, d.max(),
                                                          (d > 0).mean())
        np.testing.assert_allclose(pk["sw"].numpy(),
                                   jpack["qpack"][site]["sw"], rtol=1e-6)


def test_unet_quantized_matches_jax(unets):
    module, x, jpack, want = unets
    pack = load_jax_unet_pack(module, jpack)
    got = tunet.unet_quantized(module, torch.from_numpy(x), pack["qpack"],
                               pack["scales"]).numpy()
    assert got.shape == want.shape == (2, 3, 16, 16)
    err = float(np.abs(got - want).max())
    assert err <= 1e-4 * float(np.abs(want).max()), err


def test_unet_quantized_close_to_f32(unets):
    """The port's own calibration: int8 against the f32 UNet, by
    tests/test_inference.py's norm ratio (< 0.05)."""
    module, x, _, _ = unets
    xt = torch.from_numpy(x)
    scales = tunet.unet_calibrate(module, xt)
    q = tunet.unet_quantized(module, xt, tunet.quantize_unet(module, scales),
                             scales)
    with torch.no_grad():
        f32 = module(xt)
    rel = float(torch.linalg.norm(q - f32) / torch.linalg.norm(f32 - f32.mean()))
    assert rel < 0.05, rel


def test_jax_unet_pack_with_a_stray_site_raises(unets):
    module, _, jpack, _ = unets
    bad = {"qpack": dict(jpack["qpack"]), "scales": dict(jpack["scales"])}
    bad["qpack"][("down", 9, "conv1")] = bad["qpack"][("last",)]
    with pytest.raises(KeyError):
        load_jax_unet_pack(module, bad)
