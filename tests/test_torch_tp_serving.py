"""The serving steps on a (data, model) mesh: ``make_prefill_step``,
``make_cachecraft_prefill_step`` and ``make_decode_step`` with
``shardings=`` (``training/steps.py``), the params and cache laid out by
``dryrun.serving_shardings`` (the reference's ``build_cell`` layout:
params by the rules, the rows over the data axes, the cache by
``cache_shardings``, at B 1 decode its sequence over "data"), the split
blocks with a cache (``models/model.py``) and the dry-run's closed form of
the steps' collectives (``dryrun.serving_collective_bytes``).

Seven tiny families (llama3-8b, gemma3-4b, granite-moe-1b, mamba2-370m,
recurrentgemma-9b, llama-3.2-vision-90b, musicgen-medium) on (2, 2) and
(1, 4) with 4 rows, and B 1 decode on (2, 2): a prefill of 80 tokens
into a cache of 96 slots (gemma3's and recurrentgemma's ``local`` rings
of 64 shorter than the prompt), a Cache-Craft step of 24 active tokens
(30% of the 80 prefilled positions) against a full-length prefilled
cache, and 2 decode steps after the prefill. Weights come from a seed
(the port's init, its zero-initialised norm scales and cross-attention
gates drawn from numpy so that they matter), inputs from numpy.

The reference's steps run once, jitted with its own layouts
(``jax.jit(step, in_shardings=...)``, GSPMD splitting them by the
activation rules), in a subprocess with 8 forced host devices, as
``tests/test_torch_sharded_training.py`` runs its reference.

Tolerances: the parity standard. A split layer sums its fp32 partial
products in another order than the whole one: ``LAYER_TOL`` (1e-5) for a
layer's output; logits and caches after the steps ``TOL`` (2e-4), the
same for the port against the reference (XLA's fp32 sums in its own
order). Layouts and byte counts are exact.
"""
import collections
import functools
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import get_tiny
from repro_torch.distributed import collectives as CO
from repro_torch.distributed import sharding as SH
from repro_torch.launch import dryrun as DR
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import model as TM
from repro_torch.training import steps as TS

torch.set_num_threads(2)
CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=2e-4, atol=2e-4)
LAYER_TOL = dict(rtol=0, atol=1e-5)
FAMILIES = ("llama3-8b", "gemma3-4b", "granite-moe-1b-a400m", "mamba2-370m",
            "recurrentgemma-9b", "llama-3.2-vision-90b", "musicgen-medium")
MESHES = ((2, 2), (1, 4))
B, T, S, A, DECODE = 4, 80, 96, 24, 2
CASES = [(a, s) for a in FAMILIES for s in MESHES]


def _tag(arch, shape, what):
    return f"{arch}|{shape[0]}x{shape[1]}|{what}"


def _flat(tree, prefix=""):
    """A tree of dicts and lists as {"groups/0/wq": leaf, ...}."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _np(tree):
    return {k: v.detach().cpu().numpy().copy()
            for k, v in _flat(tree).items()}


@functools.lru_cache(maxsize=None)
def weights(arch):
    """The params as numpy, from a seed: the port's init, with the norm
    scales (zero at init) and ``xattn``'s gates (zero at init, the layer
    the identity) drawn from numpy."""
    cfg = get_tiny(arch)
    params = TM.init_params(cfg, torch.Generator().manual_seed(11))
    rng = np.random.default_rng(12)
    flat = _np(params)
    for k, v in flat.items():
        name = k.rsplit("/", 1)[-1]
        if name in ("ln1", "ln2", "final_norm", "out_norm"):
            flat[k] = rng.normal(0, 0.3, v.shape).astype(np.float32)
        elif name in ("gate_attn", "gate_ffn"):
            flat[k] = rng.uniform(0.5, 1.0, v.shape).astype(np.float32)
    return flat


def _tree(flat):
    """``_flat``'s inverse for a params or cache tree."""
    tree = {}
    for k, v in flat.items():
        parts = k.split("/")
        node = tree
        for a, b in zip(parts[:-1], parts[1:]):
            key = int(a) if a.isdigit() else a
            nxt = [] if b.isdigit() else {}
            if isinstance(node, list):
                while len(node) <= key:
                    node.append(None)
                if node[key] is None:
                    node[key] = nxt
            else:
                node.setdefault(key, nxt)
            node = node[key]
        last = int(parts[-1]) if parts[-1].isdigit() else parts[-1]
        if isinstance(node, list):
            while len(node) <= last:
                node.append(None)
        node[last] = v
    tree.setdefault("groups", [])
    tree.setdefault("tail", [])
    return tree


@functools.lru_cache(maxsize=None)
def inputs(arch):
    """Numpy inputs: the prompt (tokens, or frame embeddings for
    musicgen), the media of the vision model, the Cache-Craft step's
    active positions (24 of the 80 prompt positions, per row) and tokens,
    and the decode tokens."""
    cfg = get_tiny(arch)
    rng = np.random.default_rng(13)
    out = {}
    if cfg.input_mode == "embeds":
        out["embeds"] = rng.normal(size=(B, T, cfg.d_model)).astype(
            np.float32)
        out["cc_embeds"] = rng.normal(size=(B, A, cfg.d_model)).astype(
            np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size, (B, T)).astype(
            np.int32)
        out["cc_tokens"] = rng.integers(0, cfg.vocab_size, (B, A)).astype(
            np.int32)
    if cfg.num_media_tokens:
        out["media"] = rng.normal(size=(B, cfg.num_media_tokens,
                                        cfg.d_model)).astype(np.float32)
    out["cc_positions"] = np.sort(np.stack([
        rng.choice(T, A, replace=False) for _ in range(B)]), 1).astype(
        np.int32)
    out["dec_tokens"] = rng.integers(0, cfg.vocab_size, (DECODE, B)).astype(
        np.int32)
    return out


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _batches(arch, rows=B):
    """(prefill batch, cc batch, decode batches) without caches, as torch
    tensors of the first ``rows`` rows."""
    cfg = get_tiny(arch)
    x = inputs(arch)
    media = {"media": _t(x["media"][:rows])} if "media" in x else {}
    key = "embeds" if cfg.input_mode == "embeds" else "tokens"
    pre = {key: _t(x[key][:rows]), **media}
    cc = {key: _t(x["cc_" + key][:rows]),
          "positions": _t(x["cc_positions"][:rows]), **media}
    dec = [{"tokens": _t(x["dec_tokens"][i, :rows]),
            "positions": torch.full((rows,), T + i, dtype=torch.int32)}
           for i in range(DECODE)]
    return pre, cc, dec


# ---------------- the port ----------------------------------------------------
def _params(arch):
    cfg = get_tiny(arch)
    return TM.params_from_jax(cfg, _tree(weights(arch)), CPU)


@functools.lru_cache(maxsize=None)
def port_run(arch, shape, impl, rows=B):
    """The port's steps on ``impl``: unsharded (``shape`` None) or on the
    (data, model) mesh ``shape``. Returns {what: (logits, flat cache)}
    for "prefill", "decode" (after the 2 steps from the prefill's cache;
    "decode0" the first step's logits) and "cc" (against the unsharded
    full-length prefill), numpy; with a mesh also "bytes" {what: counted},
    "layout" {what: [(leaf, block bytes, its layout's, block == slice)]},
    from the sharded result caches."""
    cfg = get_tiny(arch)
    params = _params(arch)
    pre, cc, dec = _batches(arch, rows)
    # the unsharded full-length prefill the cc step starts from
    full = TM.init_cache(cfg, rows, S, device=CPU, ring=False)
    TS.make_prefill_step(cfg, impl)(params, dict(pre, cache=full))
    out, counted, layout = {}, {}, {}
    mesh = None if shape is None else make_debug_mesh(shape, device=CPU)

    def laid(mode, tree):
        if mesh is None:
            return None, params, tree
        psh, bsh = DR.serving_shardings(cfg, mode, rows, S, mesh)
        return (psh, bsh), SH.shard_tree(params, psh), \
            SH.shard_tree(tree, bsh["cache"])

    def whole(cache):
        return _np(cache if mesh is None else SH.unshard_tree(cache))

    def blocks(what, cache):
        """Every mesh position's block of every leaf: (leaf, its slices,
        the block as numpy, its bytes, its layout's ``shard_bytes``)."""
        layout[what] = [
            (k, SH.shard_slices(st.shape, st.sharding, idx),
             st.shards[idx].numpy().copy(),
             st.shards[idx].numel() * st.shards[idx].element_size(),
             SH.shard_bytes(st.shape, st.dtype, st.sharding))
            for k, st in _flat(cache).items()
            for idx in np.ndindex(mesh.devices.shape)]

    def run(what, maker, p_tree, c_tree, batches):
        mode = {"prefill": "prefill", "cc": "partial",
                "decode": "decode"}[what]
        shs, p, c = laid(mode, c_tree)
        step = maker(cfg, impl) if shs is None else maker(
            cfg, impl, shardings=shs)
        CO.reset_bytes()
        for i, b in enumerate(batches):
            logits, c = step(p, dict(b, cache=c))
            if what == "decode" and i == 0:
                out["decode0"] = (logits.numpy(), None)
        counted[what] = {**CO.BYTES, **CO.GATHERS}
        out[what] = (logits.numpy(), whole(c))
        if mesh is not None:
            blocks(what, c)
        return c

    pc = run("prefill", TS.make_prefill_step, params,
             TM.init_cache(cfg, rows, S, device=CPU), [pre])
    run("decode", TS.make_decode_step, params,
        _tree({k: _t(v.copy()) for k, v in out["prefill"][1].items()}), dec)
    del pc
    run("cc", TS.make_cachecraft_prefill_step, params, full, [cc])
    if mesh is not None:
        out["bytes"] = counted
        out["layout"] = layout
    return out


def _gap(got, want, tol=TOL):
    """The worst ratio of two (logits, flat cache) pairs' differences to
    ``assert_allclose``'s bound (atol + rtol |want|); positions exactly."""
    pairs = [(got[0], want[0])]
    if want[1] is not None:
        for k, v in want[1].items():
            if np.issubdtype(v.dtype, np.floating):
                pairs.append((got[1][k], v))
            else:
                assert np.array_equal(got[1][k], v), k
    return max(float((np.abs(a - b) / (tol["atol"] + tol["rtol"] *
                                        np.abs(b))).max()) for a, b in pairs)


# ---------------- the reference, once, in a subprocess -----------------------
REF_CODE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_tiny
from repro.distributed import sharding as SH
from repro.launch.dryrun import _batch_axis, cache_shardings
from repro.launch.mesh import dp_size, make_debug_mesh
from repro.models import model as M
from repro.training import steps as JS
# the reference's dry-run module asks for 512 devices when imported; the
# backend starts at the first device query, so ask for 8 again first
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
assert len(jax.devices()) == 8
OUT = sys.argv[1]
FAMILIES, MESHES, B, T, S, A, DECODE = CONSTS


def tree(flat):
    out = {"groups": [], "tail": []}
    for k, v in flat.items():
        parts = k.split("/")
        if len(parts) == 1:
            out[k] = jnp.asarray(v)
            continue
        lst = out[parts[0]]
        i = int(parts[1])
        while len(lst) <= i:
            lst.append({})
        lst[i][parts[2]] = jnp.asarray(v)
    return out


def flat(t, prefix=""):
    if isinstance(t, dict):
        items = t.items()
    elif isinstance(t, (list, tuple)):
        items = enumerate(t)
    else:
        return {prefix: np.asarray(t)}
    o = {}
    for k, v in items:
        o.update(flat(v, f"{prefix}/{k}" if prefix else str(k)))
    return o


def layout(cfg, mesh, rows, kind, batch):
    b_ax = _batch_axis(mesh, rows)
    rules = SH.make_rules(mesh, cfg, batch_shard=b_ax is not None)
    bspec = NamedSharding(mesh, P(b_ax) if b_ax else P())
    with mesh, SH.axis_rules(rules):
        pspecs = SH.spec_tree(M.param_axes(cfg))
    psh = jax.tree.map(lambda s: NamedSharding(mesh, s), pspecs,
                       is_leaf=lambda x: isinstance(x, P))
    seq_axis = None
    if kind == "decode" and b_ax is None and S % dp_size(mesh) == 0 and \
            not cfg.is_attention_free:
        seq_axis = "data"
    csh = cache_shardings(cfg, mesh, batch["cache"], rows,
                          seq_axis=seq_axis, kind=kind)
    return rules, psh, {k: csh if k == "cache" else bspec for k in batch}


def sharded(cfg, mesh, rows, kind, fn, params, batches):
    rules, psh, bsh = layout(cfg, mesh, rows, kind, batches[0])
    logits, cache, outs = None, batches[0]["cache"], []
    with mesh, SH.axis_rules(rules):
        step = jax.jit(fn, in_shardings=(psh, bsh))
        for b in batches:
            logits, cache = step(params, dict(b, cache=cache))
            outs.append(np.asarray(logits))
    return outs, flat(cache)


res = {}
for arch in FAMILIES:
    cfg = get_tiny(arch)
    params = tree(dict(np.load(os.path.join(OUT, f"w_{arch}.npz"))))
    x = dict(np.load(os.path.join(OUT, f"in_{arch}.npz")))
    key = "embeds" if cfg.input_mode == "embeds" else "tokens"
    prefill = JS.make_prefill_step(cfg)
    cc = JS.make_cachecraft_prefill_step(cfg)
    decode = JS.make_decode_step(cfg)
    for shape, rows in [(m, B) for m in MESHES] + [((2, 2), 1)]:
        mesh = make_debug_mesh(shape)
        tag = f"{arch}|{shape[0]}x{shape[1]}"
        media = {"media": x["media"][:rows]} if "media" in x else {}
        pre = {key: x[key][:rows], **media}
        dec = [{"tokens": x["dec_tokens"][i, :rows],
                "positions": np.full((rows,), T + i, np.int32)}
               for i in range(DECODE)]
        if rows == 1:
            c0 = jax.jit(prefill)(params, dict(pre, cache=M.init_cache(
                cfg, 1, S, dtype=jnp.float32, ring=True)))[1]
            outs, cache = sharded(cfg, mesh, 1, "decode", decode, params,
                                  [dict(d, cache=c0) for d in dec])
            res[f"{tag}|b1|logits"] = outs[-1]
            res.update({f"{tag}|b1|cache|{k}": v for k, v in cache.items()})
            continue
        outs, cache = sharded(cfg, mesh, B, "prefill", prefill, params, [
            dict(pre, cache=M.init_cache(cfg, B, S, dtype=jnp.float32,
                                         ring=True))])
        res[f"{tag}|prefill|logits"] = outs[-1]
        res.update({f"{tag}|prefill|cache|{k}": v for k, v in cache.items()})
        outs, cache = sharded(cfg, mesh, B, "decode", decode, params,
                              [dict(d, cache=tree(cache)) for d in dec])
        res[f"{tag}|decode0|logits"] = outs[0]
        res[f"{tag}|decode|logits"] = outs[-1]
        res.update({f"{tag}|decode|cache|{k}": v for k, v in cache.items()})
        full = jax.jit(prefill)(params, dict(pre, cache=M.init_cache(
            cfg, B, S, dtype=jnp.float32, ring=False)))[1]
        ccb = {key: x["cc_" + key], "positions": x["cc_positions"], **media,
               "cache": full}
        outs, cache = sharded(cfg, mesh, B, "prefill", cc, params, [ccb])
        res[f"{tag}|cc|logits"] = outs[-1]
        res.update({f"{tag}|cc|cache|{k}": v for k, v in cache.items()})
np.savez(os.path.join(OUT, "ref.npz"), **res)
print("REF_OK")
"""


# the families split over this many reference processes, run side by
# side (the jit compiles take most of their time)
REF_PROCS = 2


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref")
    for arch in FAMILIES:
        np.savez(out / f"w_{arch}.npz", **weights(arch))
        np.savez(out / f"in_{arch}.npz", **inputs(arch))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs = []
    for i in range(REF_PROCS):
        consts = repr((FAMILIES[i::REF_PROCS], MESHES, B, T, S, A, DECODE))
        code = textwrap.dedent(REF_CODE.replace("CONSTS", consts).replace(
            "ref.npz", f"ref{i}.npz"))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code, str(out)], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    res = {}
    for i, pr in enumerate(procs):
        so, se = pr.communicate(timeout=900)
        assert pr.returncode == 0, se[-3000:]
        assert "REF_OK" in so
        res.update(np.load(out / f"ref{i}.npz"))
    return res


def _ref(ref, tag):
    cache = {k[len(tag) + 7:]: v for k, v in ref.items()
             if k.startswith(tag + "|cache|")}
    return ref[tag + "|logits"], cache or None


# ---------------- the port's sharded steps against the reference -------------
@pytest.mark.parametrize("arch,shape", CASES)
def test_sharded_steps_match_reference(ref, arch, shape):
    """Prefill, the Cache-Craft step and 2 decode steps on the mesh, on
    ``dense`` and on ``kernel`` (the wrappers' plain versions on CPU
    tensors), against the reference's jitted steps on its own layouts:
    logits and every cache leaf within 2e-4 (positions exactly)."""
    for impl in ("dense", "kernel"):
        got = port_run(arch, shape, impl)
        for what in ("prefill", "decode", "cc"):
            e = _gap(got[what], _ref(ref, _tag(arch, shape, what)))
            assert e <= 1, (impl, what, e)
        e = _gap(got["decode0"], _ref(ref, _tag(arch, shape, "decode0")))
        assert e <= 1, (impl, "decode step 1", e)


@pytest.mark.parametrize("arch", FAMILIES)
def test_b1_decode_matches_reference(ref, arch):
    """B 1 decode on (2, 2): the row stays whole, the cache's sequence
    goes over "data" (the flash-decode layout): 2 steps against the
    reference's, and against the port's unsharded steps, within 2e-4."""
    for impl in ("dense", "kernel"):
        got = port_run(arch, (2, 2), impl, rows=1)["decode"]
        e = _gap(got, _ref(ref, _tag(arch, (2, 2), "b1")))
        assert e <= 1, (impl, e)
        e = _gap(got, port_run(arch, None, impl, rows=1)["decode"])
        assert e <= 1, (impl, "unsharded", e)


@pytest.mark.parametrize("impl", ["dense", "kernel"])
@pytest.mark.parametrize("arch,shape", CASES)
def test_sharded_matches_unsharded(arch, shape, impl):
    """The sharded steps against the port's unsharded steps on the same
    route: logits and caches within 2e-4 after each of prefill, decode
    and the Cache-Craft step."""
    got, want = port_run(arch, shape, impl), port_run(arch, None, impl)
    for what in ("prefill", "decode0", "decode", "cc"):
        assert _gap(got[what], want[what]) <= 1, what


@pytest.mark.parametrize("arch,shape", CASES)
def test_cache_blocks_follow_the_layout(arch, shape):
    """Every cache block on every mesh position, after each step, holds
    its layout's ``shard_bytes`` and equals the ``shard_slices`` block of
    the unsharded step's cache within 2e-4 (positions exactly)."""
    got = port_run(arch, shape, "dense")
    want = port_run(arch, None, "dense")
    for what, rows in got["layout"].items():
        assert rows, what
        for k, sl, blk, nbytes, want_bytes in rows:
            assert nbytes == want_bytes, (what, k)
            w = want[what][1][k][sl]
            assert blk.shape == w.shape, (what, k)
            if np.issubdtype(w.dtype, np.floating):
                np.testing.assert_allclose(blk, w, **TOL,
                                           err_msg=f"{what} {k}")
            else:
                assert np.array_equal(blk, w), (what, k)


@pytest.mark.parametrize("arch,shape", CASES + [(a, "b1") for a in FAMILIES])
def test_counted_bytes_equal_closed_form(arch, shape):
    """The bytes ``collectives.py`` counts in each step (``BYTES`` and the
    serving gathers' ``GATHERS``) equal ``serving_collective_bytes``; the
    Cache-Craft step's against a full-length cache, the prefill's and
    decode's against the ring one, the decode count over its 2 steps."""
    cfg = get_tiny(arch)
    rows, mesh_shape = (1, (2, 2)) if shape == "b1" else (B, shape)
    mesh = make_debug_mesh(mesh_shape, device=CPU)
    got = port_run(arch, mesh_shape, "dense", rows=rows)["bytes"]
    want = {
        "prefill": DR.serving_collective_bytes(cfg, mesh, "prefill", rows,
                                               T, S),
        "decode": {k: DECODE * v for k, v in DR.serving_collective_bytes(
            cfg, mesh, "decode", rows, 1, S).items()},
        "cc": DR.serving_collective_bytes(cfg, mesh, "partial", rows, A, S,
                                          ring=False)}
    for what in want:
        assert got[what] == want[what], what
    if shape == "b1" and not cfg.is_attention_free:
        assert got["decode"]["kv over data"] > 0
    assert got["prefill"]["logits over model"] > 0


def test_dryrun_serving_cells_count_their_gathers():
    """The dry-run's serving cells on the production mesh report the
    serving closed form (``cell_tp_bytes``), with the kv gathers where
    the kv heads do not divide the model axis: recurrentgemma-9b's one kv
    head, its D columns over "model" in prefill, its sequence in decode;
    llama3-8b's 8 kv heads do not divide 16 either. The roofline counts
    them."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.config import SHAPES
    mesh = DR.meta_mesh(make_production_mesh(device="cpu"))
    for arch in ("recurrentgemma-9b", "llama3-8b", "mamba2-370m"):
        cfg = get_config(arch).replace(dtype="bfloat16",
                                       param_dtype="bfloat16")
        for name, sp in SHAPES.items():
            if sp["kind"] == "train":
                continue
            t = DR.cell_tp_bytes(cfg, sp["kind"], sp["global_batch"],
                                 sp["seq_len"], mesh)
            assert set(t) == {"all-gather", "all-reduce", "reduce-scatter",
                              "kv over model", "kv over data",
                              "logits over model"}
            assert t["all-reduce"] > 0 and t["logits over model"] > 0
            if arch == "mamba2-370m":
                assert t["kv over model"] == t["kv over data"] == 0
            elif sp["kind"] == "decode" or sp["seq_len"] <= cfg.window:
                assert t["kv over model"] > 0, (arch, name)


# ---------------- one split layer against the whole one -----------------------
def _split_layer(cfg, mesh, params, cache, pi, mode):
    """Layer 0 of pattern position ``pi`` as a data shard's layers see it
    on ``mesh`` (rows whole: a (1, n) mesh): its leaves ``tp_plan``
    splits as ``Blocks``, its cache as ``Tiles``."""
    psh, bsh = DR.serving_shardings(cfg, mode, B, S, mesh)
    sp = SH.shard_tree(params, psh)
    sc = SH.shard_tree(cache, bsh["cache"])
    plan = SH.tp_plan(mesh, cfg, TM.param_axes(cfg))
    n = mesh.shape["model"]
    layer = {}
    for k, st in sp["groups"][pi].items():
        r = plan["groups"][pi][k]
        if r is None:
            layer[k] = st.shards[(0, 0)][0]
        else:
            layer[k] = SH.Blocks([st.shards[(0, m)][0] for m in range(n)],
                                 r.dim, r.route)
    tiles = {k: SH.Tiles.of(v, 1, (0,))[0]
             for k, v in sc["groups"][pi].items()}
    return layer, tiles, sc


@pytest.mark.parametrize("mode", ["prefill", "partial", "decode"])
@pytest.mark.parametrize("arch", ["gemma3-4b", "recurrentgemma-9b",
                                  "llama-3.2-vision-90b", "mamba2-370m"])
def test_split_layer_matches_whole(arch, mode):
    """Each kind of layer of the family (``attn``, ``local``, ``xattn``,
    ``rglru``, ``ssd``) on (1, 4), its cache in the serving layout, in
    prefill, partial and decode on ``kernel``: the block output within
    1e-5 of the whole block's, and its cache the whole block's within
    1e-5."""
    cfg = get_tiny(arch)
    params = _params(arch)
    mesh = make_debug_mesh((1, 4), device=CPU)
    pre, cc, dec = _batches(arch)
    cache = TM.init_cache(cfg, B, S, device=CPU, ring=mode != "partial")
    TS.make_prefill_step(cfg)(params, dict(pre, cache=cache))
    rng = np.random.default_rng(5)
    if mode == "prefill":
        tq, pos = T, None
    elif mode == "partial":
        tq, pos = A, cc["positions"]
    else:
        tq, pos = 1, dec[0]["positions"][:, None]
    h = _t(rng.normal(size=(B, tq, cfg.d_model)).astype(np.float32))
    if pos is None:
        pos = torch.arange(tq, dtype=torch.int32).expand(B, tq)
    media = pre.get("media")
    for pi, kind in enumerate(cfg.pattern):
        whole_c = {k: v[0].clone() for k, v in cache["groups"][pi].items()}
        layer, tiles, sc = _split_layer(
            cfg, mesh, params, {"groups": [
                {k: v.clone() for k, v in c.items()}
                for c in cache["groups"]], "tail": []}, pi,
            "decode" if mode == "decode" else "prefill")

        def ctx():
            return TM.Ctx(cfg=cfg, mode=mode, positions=pos, media=media,
                          attn_impl="kernel",
                          decode_slot=pos[:, 0] if mode == "decode"
                          else None)
        want = TM.apply_block(ctx(), kind,
                              {k: v[0] for k, v in
                               params["groups"][pi].items()},
                              h, whole_c)[0]
        got = TM.apply_block(ctx(), kind, layer, h, tiles)[0]
        np.testing.assert_allclose(got.numpy(), want.numpy(), **LAYER_TOL,
                                   err_msg=f"{kind} out")
        got_c = SH.unshard_tree(sc)["groups"][pi]
        for k, v in whole_c.items():
            np.testing.assert_allclose(got_c[k][0].numpy(), v.numpy(),
                                       **LAYER_TOL, err_msg=f"{kind} {k}")


# ---------------- chip_smoke.py's phase 18 on the CPU -------------------------
def _phase18(monkeypatch):
    """``chip_smoke`` set up to run ``run_tp_serving`` on the CPU at tiny
    size: the configs patched to their tiny ones, the steps cut to 4 rows
    of 80 tokens, 24 active, 2 decode steps into 96 slots, the timers
    stubbed, and the chunk, decode and SSD wrappers routed through their
    launch hooks onto the plain versions, so that the phase's launch
    counts, recorders, gates and per-shard measurements run as on the
    card (the windows past the cache, as at full width). Returns the
    module."""
    import repro_torch.configs as C
    from repro_torch.kernels.chunk_attention import ops as cops
    from repro_torch.kernels.chunk_attention.ref import chunk_attention_ref
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.ssd import ops as sops
    from repro_torch.kernels.ssd.ref import ssd_intra_ref

    monkeypatch.syspath_prepend(ROOT)
    import chip_smoke as cs

    def chunk_launch(q, k, v, q_pos, k_pos, k_chunk, q_seg, k_seg, C_,
                     window):
        outs = [chunk_attention_ref(q[b], k[b], v[b], q_pos[b], k_pos[b],
                                    k_chunk[b], num_chunks=C_, window=window,
                                    q_seg=q_seg[b], k_seg=k_seg[b])
                for b in range(q.shape[0])]
        cops.chunk_attention.launches += 1
        return (torch.stack([o for o, _ in outs]),
                torch.stack([m for _, m in outs]))

    def chunk_attention(q, k, v, q_pos, k_pos, k_chunk, *, q_seg=None,
                        k_seg=None, num_chunks=16, window=0):
        return cops._launch(q, k, v, q_pos, k_pos, k_chunk,
                            torch.zeros_like(q_pos) if q_seg is None
                            else q_seg,
                            torch.zeros_like(k_pos) if k_seg is None
                            else k_seg, num_chunks, window)

    def decode_attention(q, k, v, q_pos, k_pos, *, window=0):
        B, H, D = q.shape
        out = dops._call("decode_attention", "decode_attention_fwd",
                         (q, k, v, q_pos, k_pos),
                         (B, k.shape[1], H, k.shape[2], D, int(window)), q, 1)
        decode_attention.launches += 1
        return out

    def ssd_intra(xdt, log_a, B_mat, C_mat):
        lead = xdt.shape[:-4]
        if lead:
            xdt, log_a, B_mat, C_mat = (t.flatten(0, 1) for t in
                                        (xdt, log_a, B_mat, C_mat))
        y, st = ssd_intra_ref(xdt, log_a, B_mat, C_mat)
        sops.ssd_intra.launches += 1
        sops.ssd_intra.launches_by_type[str(xdt.dtype)[6:]] += 1
        if lead:
            y, st = y.unflatten(0, lead + (-1,)), st.unflatten(0,
                                                               lead + (-1,))
        return y, st

    chunk_attention.launches = decode_attention.launches = 0
    ssd_intra.launches = 0
    ssd_intra.launches_by_type = collections.Counter()
    # the phase's Cache-Craft step runs on the prefill's cache, whose
    # local ring holds every slot at full width (a 2048-key window over
    # 576 slots): so too here
    monkeypatch.setattr(C, "get_config",
                        lambda n: C.get_tiny(n).replace(window=2 * S))
    for k, v in dict(SERVE_ROWS=B, SERVE_TOKENS=T, SERVE_ACTIVE=A,
                     SERVE_CACHE=S, SERVE_DECODE=DECODE).items():
        monkeypatch.setattr(cs, k, v)
    monkeypatch.setattr(cs, "cuda_ms", lambda fn, iters=20, warmup=3:
                        (fn(), 1.0)[1])
    monkeypatch.setattr(cs, "device_ms", lambda fn, iters=20, warmup=3,
                        windows=3: (fn(), 1.0)[1])
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(cops, "_launch", chunk_launch)
    monkeypatch.setattr(cops, "chunk_attention", chunk_attention)
    monkeypatch.setattr(dops, "_call", lambda what, entry, ptrs, ints, q, n:
                        decode_attention_ref(*ptrs, window=ints[-1]))
    monkeypatch.setattr(dops, "decode_attention", decode_attention)
    monkeypatch.setattr(sops, "ssd_intra", ssd_intra)
    return cs


def test_chip_smoke_tp_serving_rehearsal(monkeypatch):
    """``chip_smoke.run_tp_serving`` end to end on the CPU at tiny size
    (``_phase18``)."""
    import repro_torch.configs as C
    cs = _phase18(monkeypatch)
    out = cs.run_tp_serving(CPU, "cpu")
    # llama3-8b/4 and granite-moe-1b/4 on (1, 4) and (2, 2),
    # recurrentgemma-9b/3 (one local layer) on (1, 4), mamba2-370m at 2
    # and 4 layers on (1, 4); the SSD kernel on both routes
    assert out["launches"] == {
        "chunk_attention": 2 * 2 * (4 * 4 * 1 + 4 * 2 * 2) + 2 * 4,
        "decode_attention": DECODE * (2 * (4 * 4 + 4 * 2 * 2) + 4),
        "ssd_intra": 2 * 2 * (2 + 4) * 4}
    g = "granite-moe-1b-a400m"
    assert set(out["kernels"]) == {"chunk_attention", "decode_attention",
                                   "ssd_intra", f"chunk_attention {g}",
                                   f"decode_attention {g}"}
    for r in out["kernels"].values():
        assert r["float32"]["err"] <= cs.TOL["float32"]
        assert r["float32"]["unsharded_ms"] == 1.0
    # granite's rows: its own launches over both meshes, its calls at its
    # head dim, H per model shard of the whole
    assert out["kernels"][f"chunk_attention {g}"]["launches"] == \
        2 * 4 * 4 * 2
    assert out["kernels"][f"decode_attention {g}"]["launches"] == \
        DECODE * 4 * 4 * 2
    assert out["kernels"][f"chunk_attention {g}"]["shape"].endswith(
        f"D {C.get_tiny(g).head_dim}")
    # granite's runs replay the unsharded dense run's ids: no own flip
    # at tiny size on the CPU
    gr = out["granite-moe-1b-tiny/4"]
    assert gr["own_flips"] == {"unsharded kernel": 0, "[1, 4] dense": 0,
                               "[1, 4] kernel": 0, "[2, 2] dense": 0,
                               "[2, 2] kernel": 0}
    # every sharded run's counted bytes equal the closed form (the phase
    # raises otherwise), the experts' combine among them
    for name, r in out.items():
        for key, res in (r.items() if isinstance(r, dict) else ()):
            if key.startswith("["):
                for impl in ("dense", "kernel"):
                    assert set(res[impl]["coll_bytes"]) == \
                        {"prefill", "partial", "decode"}
                    assert res[impl]["coll_bytes"] == \
                        res["dense"]["coll_bytes"]
    assert gr["[2, 2]"]["dense"]["coll_bytes"]["prefill"]["all-reduce"] > 0
    assert len(out["mamba2-tiny/4"]["controls"]) == len(cs.MOE_SEEDS)
    # the whole model's float64 gate on (1, 4): every step's logits and
    # cache leaves within F64_TOL of their scale, all float64, none fp32
    f64 = out["mamba2-tiny/4"]["float64"]
    assert f64["ok"] and f64["mesh"] == [1, 4]
    assert f64["gap"]["ratio"] <= 1.0 and not f64["gap"]["beyond"]
    assert f64["dtypes"] == ["torch.float64"]
    assert f64["leaves"] == 3 * (1 + 2)     # 3 steps' logits, s and conv
    for name in ("llama3-8b-tiny/4", "granite-moe-1b-tiny/4",
                 "recurrentgemma-9b-tiny/3", "mamba2-tiny/2",
                 "mamba2-tiny/4"):
        for key, res in out[name].items():
            if key.startswith("["):
                assert res["dense"]["ratio"] <= 1.0
                assert res["kernel"]["ratio"] <= 1.0
                # granite's kernel route is held through its dense one
                assert res["dense"]["held"]
                assert res["kernel"]["held"] == (name !=
                                                 "granite-moe-1b-tiny/4")


def test_chip_smoke_split_noise_kernel_fault_fails(monkeypatch):
    """Phase 18 holds granite's sharded ``kernel`` route through its
    ``dense`` one (``SPLIT_NOISE``): a planted fault in that route, each
    data shard's decode launch handing back its rows rolled by one, must
    fail the phase at the sharded kernel-vs-dense gate."""
    from repro_torch.kernels.decode_attention import ops as dops
    cs = _phase18(monkeypatch)
    monkeypatch.setattr(cs, "TP_SERVE",
                        (("granite-moe-1b-a400m", None, ((2, 2),)),))
    plain = dops.decode_attention

    def faulty(q, *a, **kw):
        out = plain(q, *a, **kw)
        faulty.launches += 1
        return out.roll(1, 0) if q.shape[0] < B else out
    faulty.launches = 0
    monkeypatch.setattr(dops, "decode_attention", faulty)
    with pytest.raises(RuntimeError, match=r"\[2, 2\]: kernel vs dense"):
        cs.run_tp_serving(CPU, "cpu")


def test_chip_smoke_serving_replay_is_live(monkeypatch):
    """Phase 18's replay of the expert ids on the serving steps
    (``chip_smoke._replayed``, ``Routes.hand`` per step call and layer):
    tiny granite on (2, 2), replaying the unsharded run's own ids, lies
    within the parity standard of it; with one layer's ids of the prefill
    moved by one row it does not (the sharded run takes the ids it is
    handed)."""
    monkeypatch.syspath_prepend(ROOT)
    import chip_smoke as cs
    for k, v in dict(SERVE_ROWS=B, SERVE_TOKENS=T, SERVE_ACTIVE=A,
                     SERVE_CACHE=S, SERVE_DECODE=DECODE).items():
        monkeypatch.setattr(cs, k, v)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    cfg = get_tiny("granite-moe-1b-a400m")
    params = _params("granite-moe-1b-a400m")
    inp = cs._serve_inputs(cfg, CPU)
    mesh = make_debug_mesh((2, 2), device=CPU)
    sp = SH.shard_tree(params, DR.serving_shardings(cfg, "prefill", B, S,
                                                    mesh)[0])
    routes = cs.Routes()
    try:
        with torch.no_grad():
            want, ref, _ = cs._replayed(
                routes, None, 1,
                lambda: cs._serve_steps(cfg, params, inp, "dense", CPU))
            got, _, f = cs._replayed(
                routes, ref, 2, lambda: cs._serve_steps(
                    cfg, params, inp, "dense", CPU, mesh, sp))
            order = [list(layers) for layers in ref["order"]]
            order[0][1] = order[0][1].roll(1, 0)
            off, _, _ = cs._replayed(routes, dict(ref, order=order), 2,
                                     lambda: cs._serve_steps(
                                         cfg, params, inp, "dense", CPU,
                                         mesh, sp))
    finally:
        routes.close()
    assert f == 0
    assert cs._serve_gap(got, want, cs.SHARD_TOL)[0] <= 1.0
    assert cs._serve_gap(off, want, cs.SHARD_TOL)[0] > 1.0
