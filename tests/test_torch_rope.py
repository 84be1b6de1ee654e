"""The port's RoPE kernel module and the chunk-cache RPE path (re-rope on
inject, de-rope before storing) against the JAX package, on the CPU.

The wrapper takes its plain version (``kernels/rope/ref.py``) for CPU
tensors; the CUDA source itself is held against that plain version by
``test_torch_kernels_emulated.py`` (CPU emulation) and
``test_torch_kernels_cuda.py`` / ``chip_smoke.py`` (the card).

Tolerances: 1e-6 where both packages evaluate the same fp32 formula
(``apply_rope``: cos/sin of the same fp32 angle, a few ulp apart between
XLA's and PyTorch's CPU math); 4e-3 against the Pallas kernel, whose own
test (``tests/test_kernels.py``) holds it at that tolerance because it
rebuilds the frequencies as ``exp(-2 ln(theta) i / D)``; 2e-5 for the
apply-then-remove round trip, as the reference's property test."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_tiny as j_tiny
from repro.core import prefill as JP
from repro.core.chunkstore import ChunkStore as JStore
from repro.core.tiers import TieredStore as JTiers
from repro.kernels.rope import ops as jops
from repro.kernels.rope.ref import rope_ref as j_rope_ref
from repro.models import model as JM
from repro.models.layers import apply_rope as j_apply_rope
from repro_torch.configs import get_tiny
from repro_torch.core import prefill as TP
from repro_torch.core.chunkstore import ChunkStore
from repro_torch.core.tiers import TieredStore
from repro_torch.kernels.rope import ops as tops
from repro_torch.kernels.rope.ref import rope_ref
from repro_torch.models import model as TM

torch.set_num_threads(2)
EXACT = dict(rtol=1e-6, atol=1e-6)
# (T, H, D, theta): the shapes and thetas of tests/test_kernels.py
CASES = [(32, 4, 32, 1e4), (50, 2, 64, 5e5), (128, 8, 128, 1e6)]


def _inputs(seed, T, H, D, lead=()):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=lead + (T, H, D)).astype(np.float32)
    pos = rng.integers(0, 10_000, lead + (T,)).astype(np.int32)
    return x, pos


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("T,H,D,theta", CASES)
def test_plain_version_vs_jax_ref(T, H, D, theta, inverse):
    x, pos = _inputs(T * D, T, H, D)
    o = rope_ref(torch.from_numpy(x), torch.from_numpy(pos), theta=theta,
                 inverse=inverse)
    r = j_rope_ref(jnp.asarray(x), jnp.asarray(pos), theta=theta,
                   inverse=inverse)
    np.testing.assert_allclose(o.numpy(), np.asarray(r), **EXACT)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("T,H,D,theta", CASES)
def test_wrapper_vs_pallas_interpret(T, H, D, theta, inverse):
    """``ops.rope`` on CPU tensors against ``rope_pallas`` in interpret
    mode, run as the reference's own test runs it (block_t 16)."""
    x, pos = _inputs(T + D, T, H, D)
    tops.rope.launches = 0
    o = tops.rope(torch.from_numpy(x), torch.from_numpy(pos), theta=theta,
                  inverse=inverse)
    assert tops.rope.launches == 0          # CPU tensors: plain version
    r = jops.rope(jnp.asarray(x), jnp.asarray(pos), theta=theta,
                  inverse=inverse, block_t=16)
    np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=4e-3,
                               atol=4e-3)


@pytest.mark.parametrize("inverse", [False, True])
def test_wrapper_batched_forms(inverse):
    """``[B,T,H,D]`` with ``pos [B,T]`` against the JAX ``ops.rope``
    batch (vmap over rows, Pallas interpret), and with a shared ``pos
    [T]`` against the JAX ``apply_rope`` broadcast over the batch."""
    B, T, H, D, theta = 3, 20, 2, 32, 1e4
    x, pos = _inputs(7, T, H, D, lead=(B,))
    o = tops.rope(torch.from_numpy(x), torch.from_numpy(pos), theta=theta,
                  inverse=inverse)
    r = jops.rope(jnp.asarray(x), jnp.asarray(pos), theta=theta,
                  inverse=inverse, block_t=16)
    np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=4e-3,
                               atol=4e-3)
    o1 = tops.rope(torch.from_numpy(x), torch.from_numpy(pos[0]),
                   theta=theta, inverse=inverse)
    r1 = j_apply_rope(jnp.asarray(x), jnp.asarray(pos[0]), theta,
                      inverse=inverse)
    np.testing.assert_allclose(o1.numpy(), np.asarray(r1), **EXACT)


@pytest.mark.parametrize("seed", range(4))
def test_round_trip_apply_then_remove(seed):
    """apply o remove == id: the invariant the chunk-cache store relies on
    (K stored without RoPE, paper §4)."""
    rng = np.random.default_rng(seed)
    t = int(rng.integers(1, 65))
    x = torch.from_numpy(rng.normal(size=(t, 2, 16)).astype(np.float32))
    pos = torch.from_numpy(rng.integers(0, 100_000, t).astype(np.int32))
    y = tops.rope(tops.rope(x, pos, theta=1e4), pos, theta=1e4,
                  inverse=True)
    np.testing.assert_allclose(y.numpy(), x.numpy(), rtol=2e-5, atol=2e-5)


def test_wrapper_rejects_bad_shapes():
    x = torch.zeros(4, 2, 8)
    with pytest.raises(ValueError, match="pos shape"):
        tops.rope(x, torch.zeros(5, dtype=torch.int32), theta=1e4)
    with pytest.raises(ValueError, match="odd"):
        tops.rope(torch.zeros(4, 2, 7), torch.zeros(4, dtype=torch.int32),
                  theta=1e4)


# ---- the chunk-cache RPE path on tiny llama3-8b -----------------------------
@pytest.fixture(scope="module")
def world():
    cfg = get_tiny("llama3-8b")
    jcfg = j_tiny("llama3-8b")
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = TM.params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                                 "cpu")
    return cfg, jcfg, tparams, jparams


@pytest.mark.parametrize("start", [0, 37])
def test_inject_chunk_kv_vs_jax(world, start):
    """Stored (de-roped) chunk KV of tiny llama3-8b's shape [L, n, Hkv, D]
    re-roped at a layout span: the port on the CPU == the JAX package."""
    cfg, jcfg = world[:2]
    n = 24
    rng = np.random.default_rng(start)
    shape = (cfg.num_layers, n, cfg.num_kv_heads, cfg.head_dim_)
    kv = {"k": rng.normal(size=shape).astype(np.float32),
          "v": rng.normal(size=shape).astype(np.float32)}
    span = np.arange(start, start + n, dtype=np.int32)
    kt, vt = TP.inject_chunk_kv(cfg, kv, span, device="cpu")
    kj, vj = JP.inject_chunk_kv(jcfg, kv, span)
    assert kt.dtype == vt.dtype == np.float32
    np.testing.assert_allclose(kt, kj, **EXACT)
    np.testing.assert_array_equal(vt, vj)


def _stored(store):
    """chunk hash -> (k, v) of its first stored variant."""
    out = {}
    for chash, variants in store.table.items():
        kv, _info = store.get_kv(variants[0])
        out[chash] = (np.asarray(kv["k"]), np.asarray(kv["v"]))
    return out


def test_stored_derope_vs_jax_executor(world, tmp_path):
    """Both executors prefill the same request into empty stores: every
    miss chunk is stored de-roped. The port's stored K is the reference's
    RoPE removal of the port's own merged K at 1e-6, and matches the JAX
    executor's stored K and V at the model parity tolerance (2e-4, the
    two models' K differ by fp32 rounding through the layers)."""
    cfg, jcfg, tparams, jparams = world
    rng = np.random.default_rng(0)
    V = cfg.vocab_size
    chunks = [rng.integers(0, V, n) for n in (24, 17, 30)]
    sys_t, q = rng.integers(0, V, 8), rng.integers(0, V, 12)
    t_store = ChunkStore(TieredStore(1 << 28, 1 << 28, str(tmp_path / "t"),
                                     start_worker=False), 50, 4)
    j_store = JStore(JTiers(1 << 28, 1 << 28, str(tmp_path / "j"),
                            start_worker=False), 50, 4)
    res = TP.CacheCraftExecutor(cfg, tparams, t_store, use_focus=False,
                                device="cpu").process(sys_t, chunks, q)
    JP.CacheCraftExecutor(jcfg, jparams, j_store,
                          use_focus=False).process(sys_t, chunks, q)
    t_kv, j_kv = _stored(t_store), _stored(j_store)
    assert set(t_kv) == set(j_kv) and len(t_kv) >= len(chunks)
    for d in res.plan.decisions:
        if d.seg.chash not in t_kv:
            continue
        k_t, v_t = t_kv[d.seg.chash]
        s0, s1 = d.seg.start, d.seg.end
        expect = j_apply_rope(jnp.asarray(res.k_layers[:, s0:s1]),
                              jnp.arange(s0, s1), cfg.rope_theta,
                              inverse=True)
        np.testing.assert_allclose(k_t, np.asarray(expect), **EXACT)
        np.testing.assert_array_equal(v_t, res.v_layers[:, s0:s1])
        k_j, v_j = j_kv[d.seg.chash]
        np.testing.assert_allclose(k_t, k_j, rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(v_t, v_j, rtol=2e-4, atol=2e-4)
    for store in (t_store, j_store):
        store.tiers.close()
