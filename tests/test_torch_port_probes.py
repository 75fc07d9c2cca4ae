"""The plain versions of the port's ceiling probes
(cwfa_tpu_torch.ops.probes) on the CPU, against the Pallas kernels of the
two JAX probe scripts run in interpret mode.

The scripts pass no ``interpret`` flag, so each is loaded with importlib and
its ``pl`` is replaced, in that module only, by a namespace whose
``pallas_call`` interprets.  ``gemm_out8`` is a closure at M = 2^20 inside
``probe_chain``: its plain version is held to the formula in its body and to
``_pallas_gemm`` plus that epilogue.

int8 results are exact (int32 sums, then an arithmetic shift and a clip), so
they must be equal.  bf16: the products are exact in f32 but the sums run in
another order, so a value can round to the neighbouring bf16 and, in the
chain, carry that through later stages: |d| <= 2^-6 * max|ref|.  The FMA
probe's ``mul`` and ``roll`` modes round once per step either way and must be
equal; ``fma`` is fused in the port's plain version (one rounding per step)
and may or may not be in the interpreted kernel, one ulp apart per step at
most: |d| <= t * 2^-22 * max|ref| on inputs with |x| <= 1, which do not
amplify an earlier step's error.

On the CPU the wrappers run the plain versions and count no launch; the
CUDA kernels are held to the plain versions on the card by chip_smoke.py.
"""

import functools
import importlib.util
import types
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from cwfa_tpu_torch.ops import probes

SCRIPTS = Path(__file__).resolve().parents[1] / "scripts"


def _load(name):
    spec = importlib.util.spec_from_file_location(f"_probe_{name}",
                                                  SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.pl = types.SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True),
        BlockSpec=pl.BlockSpec)
    return mod


@pytest.fixture(scope="module")
def micro():
    return _load("bench_int8_micro")


@pytest.fixture(scope="module")
def vpu():
    return _load("probe_vpu_rate")


def _int8(rng, *shape):
    return rng.randint(-127, 128, shape).astype(np.int8)


def _bf16(rng, *shape, scale=1.0):
    x = torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32))
    return x.to(torch.bfloat16)


def _to_jnp_bf16(t):
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _from_jnp(a):
    return np.asarray(a.astype(jnp.float32))


def test_requant_shift_is_arithmetic():
    acc = np.array([-1, -127, -128, -129, 127, 128, 255, 256, 16255, 16256,
                    17000, -16256, -16257, -16384, -40000, 40000], np.int32)
    want = np.asarray(jnp.clip(jnp.asarray(acc) >> 7, -127, 127)
                      .astype(jnp.int8))
    got = probes.requant(torch.from_numpy(acc))
    assert got.dtype == torch.int8
    assert np.array_equal(got.numpy(), want)
    # toward minus infinity, not toward zero
    assert got[:4].tolist() == [-1, -1, -1, -2] and got[-2:].tolist() == [-127, 127]


@pytest.mark.parametrize("m,k,n,tile_m", [(64, 48, 16, 32), (96, 160, 40, 32)])
def test_tiled_gemm_int8_equals_pallas(micro, m, k, n, tile_m):
    rng = np.random.RandomState(0)
    a, b = _int8(rng, m, k), _int8(rng, k, n)
    a[0] = -127                                  # a row of large negative sums
    b[:, 0] = 127
    want = np.asarray(micro._pallas_gemm(jnp.asarray(a), jnp.asarray(b),
                                         jnp.int32, jnp.int32, tile_m=tile_m))
    launches = probes.tiled_gemm.launches
    got = probes.tiled_gemm(torch.from_numpy(a), torch.from_numpy(b))
    assert probes.tiled_gemm.launches == launches        # CPU: plain
    assert got.dtype == torch.int32 and want[0, 0] == -127 * 127 * k
    assert np.array_equal(got.numpy(), want)
    # gemm_out8: the formula of its body on the Pallas sums, and on ours
    want8 = np.asarray(jnp.clip(jnp.asarray(want) >> 7, -127, 127)
                       .astype(jnp.int8))
    got8 = probes.tiled_gemm(torch.from_numpy(a), torch.from_numpy(b),
                             out8=True)
    assert got8.dtype == torch.int8 and got8[0, 0] == -127
    assert np.array_equal(got8.numpy(), want8)
    assert np.array_equal(got8.numpy(), probes.requant(got).numpy())
    assert (want8 < 0).any() and (want8 == 127).any()


def test_tiled_gemm_bf16_close_to_pallas(micro):
    rng = np.random.RandomState(1)
    a, b = _bf16(rng, 64, 96), _bf16(rng, 96, 24)
    want = _from_jnp(micro._pallas_gemm(_to_jnp_bf16(a), _to_jnp_bf16(b),
                                        jnp.bfloat16, jnp.float32, tile_m=32))
    got = probes.tiled_gemm(a, b)
    assert got.dtype == torch.bfloat16
    assert np.abs(got.float().numpy() - want).max() <= 2.0 ** -6 * np.abs(want).max()


@pytest.mark.parametrize("depth", [1, 3])
def test_chained_gemm_int8_equals_pallas(micro, depth):
    rng = np.random.RandomState(2)
    x, ws = _int8(rng, 64, 128), _int8(rng, depth, 128, 128) // 8
    want = np.asarray(micro._chained(jnp.asarray(x), jnp.asarray(ws), depth,
                                     32, jnp.int8, jnp.int32))
    got = probes.chained_gemm(torch.from_numpy(x), torch.from_numpy(ws))
    assert got.dtype == torch.int8 and got.shape == (64, 128)
    assert np.array_equal(got.numpy(), want)
    assert (want < 0).any() and (want > 0).any() and np.abs(want).max() == 127


def test_chained_gemm_bf16_close_to_pallas(micro):
    rng = np.random.RandomState(3)
    x, ws = _bf16(rng, 64, 128), _bf16(rng, 3, 128, 128, scale=0.1)
    want = _from_jnp(micro._chained(_to_jnp_bf16(x), _to_jnp_bf16(ws), 3, 32,
                                    jnp.bfloat16, jnp.float32))
    got = probes.chained_gemm(x, ws).float().numpy()
    assert want.min() == 0 and want.max() > 1     # the ReLU bites
    assert np.abs(got - want).max() <= 2.0 ** -6 * want.max()


def _pallas_fma(vpu, x, y, t, u, mode):
    kern = functools.partial(vpu.fma_kernel, t=t, u=u, mode=mode)
    return np.asarray(pl.pallas_call(
        kern, in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 2,
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32),
        interpret=True)(jnp.asarray(x), jnp.asarray(y)))


@pytest.mark.parametrize("mode", probes.FMA_MODES)
@pytest.mark.parametrize("u", [1, 3])
def test_fma_probe_matches_pallas(vpu, mode, u):
    rng = np.random.RandomState(4)
    t = 6
    x = rng.uniform(-1, 1, (16, 128)).astype(np.float32)
    y = rng.randn(16, 128).astype(np.float32)
    want = _pallas_fma(vpu, x, y, t, u, mode)
    launches = probes.fma_probe.launches
    got = probes.fma_probe(torch.from_numpy(x), torch.from_numpy(y), t=t, u=u,
                           mode=mode).numpy()
    assert probes.fma_probe.launches == launches
    if mode == "fma":
        assert np.abs(got - want).max() <= t * 2.0 ** -22 * np.abs(want).max()
    else:
        assert np.array_equal(got, want)


def test_fma_probe_at_the_probe_own_inputs(vpu):
    """x = 1.0000001, y = 1e-9 (``run``): the value grows by ~y per step and
    the fused and the two-rounding form stay within t ulps."""
    x = np.full((8, 128), 1.0000001, np.float32)
    y = np.full((8, 128), 1e-9, np.float32)
    t, u = 64, 2
    want = _pallas_fma(vpu, x, y, t, u, "fma")
    got = probes.fma_probe(torch.from_numpy(x), torch.from_numpy(y), t=t, u=u,
                           mode="fma").numpy()
    assert np.all(np.abs(got - want) <= t * 2.0 ** -23 * want)
    assert np.allclose(want, u * t * 1e-9, rtol=0.02)


def test_roll_is_a_rotation_by_one_along_the_columns():
    x = torch.zeros(2, 128)
    y = torch.zeros(2, 128)
    y[0, 5] = y[1, 127] = 1.0
    # u = 1: a0 = y / 2, rolled twice, y added after each roll
    got = probes.fma_probe(x, y, t=2, u=1, mode="roll")
    want = torch.roll(torch.roll(0.5 * y, 1, 1) + y, 1, 1) + y
    assert torch.equal(got, want)
    assert got[1, 1] == 0.5 and got[1, 0] == 1.0 and got[1, 127] == 1.0


def test_wrappers_reject_what_the_kernels_do_not_take():
    a = torch.zeros(4, 8, dtype=torch.int8)
    with pytest.raises(ValueError):                 # inner sizes differ
        probes.tiled_gemm(a, torch.zeros(4, 8, dtype=torch.int8))
    with pytest.raises(TypeError):                  # mixed types
        probes.tiled_gemm(a, torch.zeros(8, 4, dtype=torch.bfloat16))
    with pytest.raises(TypeError):                  # f32 has no kernel
        probes.tiled_gemm(a.float(), torch.zeros(8, 4))
    with pytest.raises(TypeError):                  # out8 is int8's epilogue
        probes.tiled_gemm(a.to(torch.bfloat16),
                          torch.zeros(8, 4, dtype=torch.bfloat16), out8=True)
    with pytest.raises(ValueError):                 # not contiguous
        probes.tiled_gemm(a.t(), torch.zeros(4, 4, dtype=torch.int8))
    with pytest.raises(ValueError):                 # ws not (depth, C, C)
        probes.chained_gemm(a, torch.zeros(2, 8, 4, dtype=torch.int8))
    f = torch.zeros(2, 128)
    with pytest.raises(ValueError):
        probes.fma_probe(f, f, t=1, u=17, mode="fma")
    with pytest.raises(ValueError):
        probes.fma_probe(f, f, t=1, u=1, mode="add")
    with pytest.raises(ValueError):                 # not 128 wide
        probes.fma_probe(f[:, :64].contiguous(), f[:, :64].contiguous(), t=1,
                         u=1, mode="fma")
    with pytest.raises(RuntimeError):               # neither CPU nor CUDA
        probes.fma_probe(f.to("meta"), f.to("meta"), t=1, u=1, mode="fma")


@pytest.mark.parametrize("m,k,n", [(37, 20, 5), (129, 100, 130),
                                   (100, 161, 24)])
def test_tiled_gemm_bf16_plain_version_at_odd_shapes(m, k, n):
    """The plain version the card's bf16 kernel is held against, at sizes
    that are no multiple of its tiles: exact products, f32 sums, one
    rounding to bf16 (<= 2^-8 of each value, the kernel's bound is 2^-7 of
    the largest)."""
    rng = np.random.RandomState(11)
    a, b = _bf16(rng, m, k), _bf16(rng, k, n)
    got = probes.tiled_gemm(a, b)
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    want = a.double() @ b.double()
    assert ((got.double() - want).abs() <= 2.0 ** -8 * want.abs() + 1e-6).all()


def test_kernel_library_names_follow_the_headers(tmp_path, monkeypatch):
    """A library's name carries a hash of every source and of every header
    beside them, so an edit to the shared wgmma header rebuilds."""
    from cwfa_tpu_torch.ops import cuda_build
    (tmp_path / "a.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(cuda_build, "CSRC", tmp_path)
    first = cuda_build.library_paths()
    assert set(first) == {"a"}
    assert cuda_build.library_paths() == first
    (tmp_path / "h.cuh").write_text("// two\n")
    assert cuda_build.library_paths()["a"] != first["a"]
    monkeypatch.undo()
    assert "wgmma.cuh" in {p.name for p in cuda_build.CSRC.glob("*.cuh")}


def test_wgmma_header_is_what_its_script_writes():
    """csrc/wgmma.cuh is generated (its instruction wrappers are operand
    lists that differ only in N): the committed header is the output of
    scripts/torch_gen_wgmma_header.py."""
    path = (Path(__file__).resolve().parents[1] / "scripts"
            / "torch_gen_wgmma_header.py")
    spec = importlib.util.spec_from_file_location("torch_gen_wgmma_header", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.HEADER.read_text() == mod.render()
    assert "wgmma_ss_bf16<256>" in mod.render()
