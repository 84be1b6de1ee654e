"""The port's fp8 chunk-cache tier codec against the reference's.

The port casts through ``torch.float8_e4m3fn`` and keeps the payload as
its ``uint8`` bit view; the reference casts through ``ml_dtypes`` (which
ships with jax, and which the GPU host does not have). Both round to
nearest even and the blockwise scale keeps every value within +-448, so
the stored bytes must be equal bit for bit, and the port must stay fp8
(never degrade to int8) without ``ml_dtypes``."""
import importlib.util
import sys

import numpy as np
import pytest

from repro.core import tiers as J
from repro_torch.core import tiers as T


def _kv_tree(seed=0, L=4, n=48, hkv=2, d=16):
    """KV-shaped leaves as the chunk store keeps them, an odd-sized leaf
    (ragged last fp8 block), a leaf spanning many binades and one under
    ``QUANT_MIN_ELEMS`` (stays raw)."""
    rng = np.random.default_rng(seed)
    return {
        "k": (rng.normal(size=(L, n, hkv, d)) * 3).astype(np.float32),
        "v": rng.normal(size=(L, n, hkv, d)).astype(np.float32),
        "odd": rng.normal(size=(3, 2 * T.FP8_BLOCK + 7)).astype(np.float32),
        "wide": (rng.normal(size=500)
                 * 10.0 ** rng.integers(-9, 4, 500)).astype(np.float32),
        "tiny": np.ones(8, np.float32),
    }


def _assert_same_encoding(q_port, q_ref):
    assert q_port.scheme == q_ref.scheme == "fp8"
    assert q_port.nbytes == q_ref.nbytes
    for pp, pr, sp, sr in zip(q_port.leaves, q_ref.leaves, q_port.scales,
                              q_ref.scales):
        if sr is None:
            assert sp is None
            np.testing.assert_array_equal(pp, pr)
            continue
        assert pp.dtype == np.uint8 and pp.shape == pr.shape
        np.testing.assert_array_equal(pp, pr.view(np.uint8))
        np.testing.assert_array_equal(sp, sr)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fp8_encoding_bit_identical_to_reference(seed):
    tree = _kv_tree(seed)
    q_port, q_ref = T.quantize_tree(tree, "fp8"), J.quantize_tree(tree,
                                                                  "fp8")
    _assert_same_encoding(q_port, q_ref)
    out_port, out_ref = T.dequantize_tree(q_port), J.dequantize_tree(q_ref)
    for name in tree:
        np.testing.assert_array_equal(out_port[name],
                                      np.asarray(out_ref[name]))
        assert np.abs(out_port[name] - tree[name]).max() <= \
            T.quant_error_bound(tree[name], "fp8")


def test_fp8_stays_fp8_without_ml_dtypes(monkeypatch, tmp_path):
    """A fresh copy of the port's tiers module, imported with
    ``ml_dtypes`` hidden (as on the GPU host), keeps the fp8 scheme for
    both ``quantize_tree`` and a tier store's configuration, and encodes
    the same bytes."""
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)
    spec = importlib.util.spec_from_file_location("_tiers_no_ml",
                                                  T.__file__)
    mod = importlib.util.module_from_spec(spec)
    monkeypatch.setitem(sys.modules, spec.name, mod)
    spec.loader.exec_module(mod)
    tree = _kv_tree(3)
    q = mod.quantize_tree(tree, "fp8")
    assert q.scheme == "fp8"
    _assert_same_encoding(q, J.quantize_tree(tree, "fp8"))
    ts = mod.TieredStore(1 << 20, 1 << 20, str(tmp_path),
                         start_worker=False, tier_dtypes={"cpu": "fp8",
                                                          "ssd": "fp8"})
    assert ts.tier_dtypes["cpu"] == ts.tier_dtypes["ssd"] == "fp8"
    ts.close()


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_fp8_ssd_files_cross_read(tmp_path, writer):
    """An fp8 SSD entry written by one package is read back by the
    other with the same values (the payload persists as uint8 bits)."""
    tree = _kv_tree(4)
    mods = (T, J) if writer == "port" else (J, T)
    w = mods[0].TieredStore(1 << 20, 1 << 20, str(tmp_path),
                            start_worker=False, tier_dtypes={"ssd": "fp8"})
    w.put("a", tree, prefer="ssd")
    w.close()
    r = mods[1].TieredStore(1 << 20, 1 << 20, str(tmp_path),
                            start_worker=False, tier_dtypes={"ssd": "fp8"})
    assert r.where("a") == "ssd"
    out, _info = r.get("a", promote=False)
    expect = T.dequantize_tree(T.quantize_tree(tree, "fp8"))
    for name in tree:
        np.testing.assert_array_equal(np.asarray(out[name]), expect[name])
    r.close()
