"""Port harness: the PyTorch package stands alone (no JAX, nothing of
the reference package) and its entry points never fall back to the CPU
on their own."""
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch.configs import get_tiny
from repro_torch.serving.api import EngineSpec, build_engine

SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")


def test_port_imports_no_jax_and_no_reference():
    """Import repro_torch and EVERY submodule in a fresh interpreter, and
    chip_smoke.py, then check that neither jax nor any module of the
    reference package got loaded (module-level imports only; nothing is
    built or launched), that no ``XLA_FLAGS`` got set and CUDA was not
    initialised (the dry-run included). chip_smoke.py imports inside its
    functions, so every import statement in it is read too."""
    code = textwrap.dedent("""
        import ast, importlib, pkgutil, sys
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for n in names:
            importlib.import_module(n)
        sys.path.insert(0, ROOT)
        import chip_smoke
        tree = ast.parse(open(chip_smoke.__file__).read())
        mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                for a in n.names}
        mods |= {n.module for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom) and n.module}
        assert "repro_torch.models" in mods, sorted(mods)
        assert not [m for m in mods if m.split(".")[0] in ("jax", "repro")]
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "repro" or m.startswith("repro.")
                     or m == "ml_dtypes")
        assert not bad, bad
        for must in ("repro_torch.core.prefill", "repro_torch.serving.engine",
                     "repro_torch.kernels.chunk_attention.ops",
                     "repro_torch.kernels.decode_attention.ops",
                     "repro_torch.kernels.ssd.ops",
                     "repro_torch.kernels.rope.ops",
                     "repro_torch.serving.server",
                     "repro_torch.training.steps",
                     "repro_torch.training.optimizer",
                     "repro_torch.training.checkpoint",
                     "repro_torch.training.data",
                     "repro_torch.launch.serve",
                     "repro_torch.launch.train",
                     "repro_torch.configs.gemma3_4b",
                     "repro_torch.configs.granite_moe_1b",
                     "repro_torch.configs.phi3_5_moe_42b",
                     "repro_torch.configs.llama3_2_3b",
                     "repro_torch.configs.deepseek_7b",
                     "repro_torch.configs.deepseek_67b",
                     "repro_torch.configs.musicgen_medium",
                     "repro_torch.configs.recurrentgemma_9b",
                     "repro_torch.configs.llama3_2_vision_90b",
                     "repro_torch.core.select",
                     "repro_torch.launch.mesh",
                     "repro_torch.distributed.sharding",
                     "repro_torch.distributed.collectives",
                     "repro_torch.distributed.compression",
                     "repro_torch.launch.roofline",
                     "repro_torch.launch.dryrun"):
            assert must in sys.modules, must
        # the dry-run runs on meta tensors: importing it sets no XLA
        # flag (the reference's forces 512 host devices) and starts no
        # CUDA
        import os, torch
        assert "XLA_FLAGS" not in os.environ
        assert not torch.cuda.is_initialized()
        print(len(names))
    """)
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    code = code.replace("ROOT", repr(os.path.dirname(SRC)))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 30


def test_build_engine_requires_gpu_unless_cpu_asked():
    if torch.cuda.is_available():
        pytest.skip("host has a GPU: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        build_engine(EngineSpec(pool_blocks=64))
    # injected CPU weights do not change the answer: the device is the
    # spec's, and it defaults to cuda
    from repro_torch.models import model as M
    cfg = get_tiny("llama3-8b")
    gen = torch.Generator().manual_seed(0)
    params = M.init_params(cfg, gen)
    with pytest.raises(RuntimeError, match="cuda"):
        build_engine(EngineSpec(pool_blocks=64), cfg=cfg, params=params)
    eng = build_engine(EngineSpec(pool_blocks=64, device="cpu"), cfg=cfg,
                       params=params)
    assert eng.device.type == "cpu"


def test_spec_validation_names_field():
    with pytest.raises(ValueError, match="attn_impl"):
        EngineSpec(attn_impl="nope", device="cpu").validate()
    with pytest.raises(ValueError, match="device"):
        EngineSpec(device="tpu").validate()
    with pytest.raises(ValueError, match="strategy|unknown"):
        EngineSpec(strategy="nope", device="cpu").validate()


@pytest.mark.parametrize("impl,fallback", [("sharded", "dense"),
                                           ("flash_cp", "flash")])
def test_mesh_backends_without_mesh_equal_fallback(impl, fallback):
    """With no mesh installed, ``sharded`` is ``dense`` and ``flash_cp`` is
    ``flash``, bit for bit, as in the reference (a one-device process
    keeps working)."""
    import numpy as np

    from repro_torch.models import backend as AB
    from repro_torch.models import model as M
    AB.set_serving_mesh(None)
    AB.set_cp_mesh(None)
    cfg = get_tiny("llama3-8b")
    params = M.init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 24))
        .astype(np.int32))
    got = M.forward(cfg, params, tokens=toks, attn_impl=impl)
    want = M.forward(cfg, params, tokens=toks, attn_impl=fallback)
    assert torch.equal(got.logits, want.logits)


@pytest.mark.parametrize("kind", ["xattn", "rglru"])
def test_other_layer_families_not_ported(kind):
    """The two families that were the port's last gap (the name is kept
    from when they raised): each now initialises, holds its cache and
    runs a prefill inside an attention model; only a kind the reference
    lacks is refused."""
    from repro_torch.models import model as M
    cfg = get_tiny("llama3-8b").replace(pattern=("attn", kind),
                                        num_media_tokens=8)
    params = M.init_params(cfg, torch.Generator().manual_seed(0))
    media = torch.randn(1, 8, cfg.d_model) if kind == "xattn" else None
    out = M.prefill(cfg, params, torch.zeros((1, 16), dtype=torch.int32),
                    media=media)
    assert bool(torch.isfinite(out.logits).all())
    leaf = out.cache["groups"][1]
    assert sorted(leaf) == (["mk", "mv"] if kind == "xattn"
                            else ["conv", "h"])
    bad = cfg.replace(pattern=("attn", "lstm"))
    with pytest.raises(ValueError, match="lstm"):
        M.init_params(bad, torch.Generator().manual_seed(0))


def test_ssd_layer_family_ported():
    from repro_torch.models import model as M
    cfg = get_tiny("mamba2-370m")
    assert cfg.pattern == ("ssd",)
    params = M.init_params(cfg, torch.Generator().manual_seed(0))
    cache = M.init_cache(cfg, 1, 8, device="cpu")
    out = M.forward(cfg, params, tokens=torch.zeros((1, 8), dtype=torch.int32),
                    mode="prefill", cache=cache)
    assert tuple(out.logits.shape) == (1, 8, cfg.padded_vocab)
    assert bool(torch.isfinite(out.logits).all())


@pytest.mark.parametrize("arch", ["gemma3-4b", "granite-moe-1b-a400m",
                                  "phi3.5-moe-42b-a6.6b", "musicgen-medium"])
def test_local_moe_and_embeds_families_ported(arch):
    """Random init and a prefill of every new family through the
    registry: ``local`` layers into a ring cache of ``window`` slots, the
    MoE FFN with its aux loss in train mode, musicgen's ``embeds``."""
    from repro_torch.models import model as M
    cfg = get_tiny(arch)
    params = M.init_params(cfg, torch.Generator().manual_seed(0))
    T = cfg.window + 8 if "local" in cfg.layer_kinds else 16
    inp = ({"embeds": torch.randn(1, T, cfg.d_model) * 0.02}
           if cfg.input_mode == "embeds"
           else {"tokens": torch.zeros((1, T), dtype=torch.int32)})
    out = M.prefill(cfg, params, **inp)
    assert tuple(out.logits.shape) == (1, T, cfg.padded_vocab)
    assert bool(torch.isfinite(out.logits).all())
    slots = [c["k"].shape[-3] for c in out.cache["groups"]]
    assert slots == [cfg.window if k == "local" else T
                     for k in cfg.pattern]
    train = M.forward(cfg, params, mode="train", **inp)
    assert (float(train.aux_loss) > 0) == bool(cfg.num_experts)


def test_pack_paged_cache_requires_device():
    """The pool-twin upload names its device: no host default (like
    ``pack_cache`` and ``init_cache``), so a caller cannot build the
    paged decode cache on the CPU by leaving the argument out."""
    import numpy as np

    from repro_torch.core.prefill import pack_paged_cache
    cfg = get_tiny("llama3-8b")
    L, NB, bs, Hkv, D = cfg.num_layers, 3, 4, cfg.num_kv_heads, cfg.head_dim_
    k = np.random.default_rng(0).normal(size=(L, NB, bs, Hkv, D))
    pos = np.arange(NB * bs, dtype=np.int32).reshape(NB, bs)
    with pytest.raises(TypeError):
        pack_paged_cache(cfg, k, k, pos)
    cache = pack_paged_cache(cfg, k, k, pos, device="cpu")
    leaves = cache["groups"] + cache["tail"]
    assert leaves and all(c["kp"].device.type == "cpu" for c in leaves)
    assert tuple(leaves[0]["kp"].shape[-3:]) == (NB * bs, Hkv, D)
