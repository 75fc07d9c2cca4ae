"""Each module of the PyTorch port that the reconstruction slice runs, held to
its JAX function at a tiny width, in f32 (rtol 1e-4 of the largest output).

Weights go across through cwfa_tpu_torch.engine.jax_params.load_jax_params;
the deterministic-init leaves (BatchNorm / LayerNorm affine and statistics,
PReLU alphas) are randomized first so that a wrong mapping shows.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import cwfa_tpu.data.views as jviews
import cwfa_tpu.flow.coupling as jcoupling
import cwfa_tpu.flow.subnets as jsubnets
import cwfa_tpu.models.cond_net as jcond
import cwfa_tpu.models.cwf as jcwf
# cwfa_tpu.models exports functions named lrnn and unet, which shadow the
# submodules of the same names: import the names themselves
from cwfa_tpu.models.lrnn import (LRNNSpec as JLRNNSpec, init_lrnn,
                                  lrnn as jlrnn, lrnn_mean_branch)
from cwfa_tpu.models.unet import UNetSpec as JUNetSpec, init_unet, unet as junet

from cwfa_tpu_torch.data import views as tviews
from cwfa_tpu_torch.engine.jax_params import load_jax_params
from cwfa_tpu_torch.flow import coupling as tcoupling
from cwfa_tpu_torch.flow import subnets as tsubnets
from cwfa_tpu_torch.models import cond_net as tcond
from cwfa_tpu_torch.models import cwf as tcwf
from cwfa_tpu_torch.models import lrnn as tlrnn
from cwfa_tpu_torch.models import unet as tunet

_RANDOMIZED = {"scale": (0.5, 1.5), "bias": (-0.2, 0.2), "alpha": (0.05, 0.5),
               "mean": (-0.2, 0.2), "var": (0.5, 1.5)}


def randomize_fixed_leaves(tree, rng):
    """numpy copy of a JAX pytree with the fixed-init leaves randomized."""
    if isinstance(tree, dict):
        return {k: (rng.uniform(*_RANDOMIZED[k], np.shape(v)).astype(np.float32)
                    if k in _RANDOMIZED else randomize_fixed_leaves(v, rng))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [randomize_fixed_leaves(v, rng) for v in tree]
    return np.asarray(tree)


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def assert_close(got, want, rtol=1e-4):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


@pytest.mark.parametrize("first", [False, True])
def test_subnet_tower_matches_jax(first):
    key = jax.random.PRNGKey(1)
    if first:
        params = jsubnets.init_wavelet_flow_subnet2d_first(key, 6, 6, n_ch=8)
        module = tsubnets.WaveletFlowSubnet2dFirst(6, 6, n_ch=8)
        fn = jsubnets.wavelet_flow_subnet2d_first
        x = _x(2, 6, 8, 8)
    else:
        params = jsubnets.init_wavelet_flow_subnet2d(key, 3, 6, n_ch=8)
        module = tsubnets.WaveletFlowSubnet2d(3, 6, n_ch=8)
        fn = jsubnets.wavelet_flow_subnet2d
        x = _x(2, 3, 8, 8)
    params = randomize_fixed_leaves(params, np.random.RandomState(0))
    load_jax_params(module, params, {})
    assert_close(module(torch.from_numpy(x)), fn(_jnp(params), jnp.asarray(x)))


@pytest.mark.parametrize("rev", [False, True])
def test_cat_transform_matches_jax(rev):
    params = jsubnets.init_wavelet_flow_subnet2d(jax.random.PRNGKey(2), 3, 6,
                                                 n_ch=8)
    module = tsubnets.WaveletFlowSubnet2d(3, 6, n_ch=8)
    load_jax_params(module, randomize_fixed_leaves(params, np.random.RandomState(0)), {})
    x, cond = _x(2, 3, 8, 8, seed=1), _x(2, 3, 8, 8, seed=2)
    y_j, ld_j = jcoupling.cat_transform(jsubnets.wavelet_flow_subnet2d, params,
                                        jnp.asarray(x), (jnp.asarray(cond),),
                                        rev=rev)
    y_t, ld_t = tcoupling.cat_transform(module, torch.from_numpy(x),
                                        (torch.from_numpy(cond),), rev=rev)
    assert_close(y_t, y_j)
    assert_close(ld_t, ld_j)


def test_cond_network_matches_jax():
    params = jcond.init_cond_network(jax.random.PRNGKey(3), 4, 6, chans_3d=4)
    params = randomize_fixed_leaves(params, np.random.RandomState(0))
    module = tcond.CondNetwork(4, 6, chans_3d=4).eval()
    load_jax_params(module, params, {})
    x = _x(2, 4, 8, 8)
    got = module(torch.from_numpy(x))
    assert got.is_contiguous()
    assert_close(got, jcond.cond_network(_jnp(params), jnp.asarray(x)))


def _tiny_unet_spec(spec_cls):
    return spec_cls(in_channels=3, n_classes=3, depth=3, wf=2,
                    batch_norm=True, use_bias=True, skip_conn=True)


def test_unet_eval_matches_jax():
    params, state = init_unet(jax.random.PRNGKey(4), _tiny_unet_spec(JUNetSpec))
    rng = np.random.RandomState(0)
    params = randomize_fixed_leaves(params, rng)
    state = randomize_fixed_leaves(state, rng)
    module = tunet.UNet(_tiny_unet_spec(tunet.UNetSpec)).eval()
    load_jax_params(module, params, state)
    x = _x(2, 3, 16, 16)
    want, _ = junet(_tiny_unet_spec(JUNetSpec), _jnp(params), _jnp(state),
                         jnp.asarray(x), train=False)
    assert_close(module(torch.from_numpy(x)), want)


def test_lrnn_and_mean_branch_match_jax():
    def spec(lrnn_spec_cls, unet_spec_cls):
        return lrnn_spec_cls(ch_in=4, n_depths=3, spatial=16, use_bias=True,
                             unet=_tiny_unet_spec(unet_spec_cls),
                             convnext_width=8)
    jspec = spec(JLRNNSpec, JUNetSpec)
    params, state = init_lrnn(jax.random.PRNGKey(5), jspec)
    rng = np.random.RandomState(0)
    params = randomize_fixed_leaves(params, rng)
    state = randomize_fixed_leaves(state, rng)
    module = tlrnn.LRNN(spec(tlrnn.LRNNSpec, tunet.UNetSpec)).eval()
    load_jax_params(module, params, state)
    x, mv = _x(2, 4, 16, 16, seed=1), _x(1, 3, 16, 16, seed=2)
    mb_j = lrnn_mean_branch(jspec, _jnp(params), jnp.asarray(mv))
    with torch.inference_mode():
        mb_t = tlrnn.lrnn_mean_branch(module, torch.from_numpy(mv))
        out_t = module(torch.from_numpy(x), mean_vol=torch.from_numpy(mv))
    assert_close(mb_t, mb_j)
    out_j, _ = jlrnn(jspec, _jnp(params), _jnp(state), jnp.asarray(x),
                          jnp.broadcast_to(jnp.asarray(mv), (2, 3, 16, 16)),
                          train=False)
    assert_close(out_t, out_j)


def test_cwf_step_reverse_fast_matches_jax():
    """B=2 with a batch-1 mean cache: the coupling blocks read s and t at
    channel offsets of each tower output, and the input block's t is a
    stride-0 expand."""
    args = (16, 16, 1, 3, "CAT", 8, True, True, False, 42)
    jspec = jcwf.build_step_specs(*args)[0]
    tspec = tcwf.build_step_specs(*args)[0]
    params = randomize_fixed_leaves(
        jcwf.init_cwf_step(jax.random.PRNGKey(6), jspec),
        np.random.RandomState(0))
    step = tcwf.CWFStep(tspec)
    load_jax_params(step, params, {})
    z, avg, cv = (_x(2, 8, 16, 16, seed=s) for s in (1, 2, 3))
    cm = _x(1, 8, 16, 16, seed=4)
    want, _ = jcwf.cwf_step_reverse(
        jspec, _jnp(params), jnp.asarray(z), jnp.asarray(avg), jnp.asarray(cv),
        jnp.broadcast_to(jnp.asarray(cm), (2, 8, 16, 16)), fast=True)
    got = step.reverse_fast(*(torch.from_numpy(a) for a in (z, avg, cv, cm)))
    assert_close(got, want)


def test_extract_views_matches_jax_off_the_edge():
    img, view = 40, 16
    coords = np.array([[4, 4], [36, 20], [20, 38], [20, 20], [-3, 45]])
    vidx_j = jviews.make_view_indices(coords, (img, img), (view, view))
    vidx_t = tviews.make_view_indices(coords, (img, img), (view, view))
    for k in vidx_j:
        np.testing.assert_array_equal(vidx_t[k], vidx_j[k])
    frames = _x(2, img, img)
    want = np.asarray(jviews.extract_views(jnp.asarray(frames), vidx_j))
    got = tviews.extract_views(torch.from_numpy(frames), vidx_t).numpy()
    assert want[:, 0, 0, 0].tolist() == [0.0, 0.0]   # end-aligned padding
    np.testing.assert_array_equal(got, want)


def test_step_specs_and_permutations_match_jax():
    args = (96, 64, 4, 4, "CAT", 64, True, True, False, 364898)
    for sj, st in zip(jcwf.build_step_specs(*args),
                      tcwf.build_step_specs(*args)):
        assert (sj.step, sj.d_in, sj.c_flow, sj.n_blocks) == \
            (st.step, st.d_in, st.c_flow, st.n_blocks)
        assert len(sj.perms) == len(st.perms) == 5
        for pj, pt in zip(sj.perms, st.perms):
            assert pj[0] == pt[0] and len(pj) == len(pt)
            for aj, at in zip(pj[1:], pt[1:]):
                np.testing.assert_array_equal(at, aj)


def test_bridge_rejects_unused_missing_and_misshaped_keys():
    params = jsubnets.init_wavelet_flow_subnet2d(jax.random.PRNGKey(7), 3, 6,
                                                 n_ch=8)
    params = randomize_fixed_leaves(params, np.random.RandomState(0))
    module = tsubnets.WaveletFlowSubnet2d(3, 6, n_ch=8)
    with pytest.raises(KeyError, match="b8.weight"):
        load_jax_params(module, {**params, "b8": params["b7"]}, {})
    with pytest.raises(KeyError, match="b7.bias"):
        load_jax_params(module, {**params, "b7": {"w": params["b7"]["w"]}}, {})
    with pytest.raises(ValueError, match="b7.weight"):
        load_jax_params(module, {**params, "b7": {
            "w": params["b7"]["w"][:, :4], "b": params["b7"]["b"]}}, {})


def test_config_copy_matches_jax():
    from cwfa_tpu.config import CWFAConfig as JConfig
    from cwfa_tpu_torch.config import CWFAConfig as TConfig
    assert dataclasses.asdict(TConfig().decode_lrs()) == \
        dataclasses.asdict(JConfig().decode_lrs())
