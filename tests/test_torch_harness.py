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
    """Import repro_torch and EVERY submodule in a fresh interpreter, then
    check that neither jax nor any module of the reference package got
    loaded (module-level imports only; nothing is built or launched)."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for n in names:
            importlib.import_module(n)
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "repro" or m.startswith("repro."))
        assert not bad, bad
        for must in ("repro_torch.core.prefill", "repro_torch.serving.engine",
                     "repro_torch.kernels.chunk_attention.ops",
                     "repro_torch.kernels.decode_attention.ops",
                     "repro_torch.launch.serve"):
            assert must in sys.modules, must
        print(len(names))
    """)
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("JAX_PLATFORMS", None)
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


@pytest.mark.parametrize("impl,item", [("flash", "A8"), ("flash_skip", "A8"),
                                       ("flash_cp", "A8"),
                                       ("sharded", "A10")])
def test_unported_backends_name_roadmap_item(impl, item):
    """Registered so a spec naming them validates, but running one says
    which ROADMAP item ports it."""
    import numpy as np

    from repro_torch.models import model as M
    cfg = get_tiny("llama3-8b")
    params = M.init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.arange(8, dtype=np.int32)[None])
    with pytest.raises(NotImplementedError, match=item):
        M.forward(cfg, params, tokens=toks, attn_impl=impl)


def test_other_layer_families_not_ported():
    from repro_torch.models import model as M
    cfg = get_tiny("llama3-8b").replace(pattern=("attn", "local"))
    with pytest.raises(NotImplementedError, match="local"):
        M.init_params(cfg, torch.Generator().manual_seed(0))
