"""The reference's bf16 deployment on the port's step roots and train step.

``repro/launch/dryrun.py`` builds every cell with ``cfg.replace(
dtype="bfloat16", param_dtype="bfloat16")`` and bf16 caches
(``M.init_cache(cfg, B, S, dtype=jnp.bfloat16)``), and runs
``make_prefill_step``, ``make_cachecraft_prefill_step``,
``make_decode_step`` and ``make_train_step`` on them. Here the port runs
the same: bf16 params (``params_from_jax`` of the bf16 weights), bf16
activations, bf16 K/V caches (``init_cache`` at ``cfg.dtype``; the
recurrent states ``h`` and ``s`` stay fp32, as the reference keeps them),
the chunk and decode kernels' pure-bf16 instantiations on ``kernel``
(their plain versions on the CPU), and the train step with bf16 params,
fp32 moments and fp32 gradient accumulation.

Tiny configs: 2 rows, a 64-token prompt into a cache of 72 slots (the
``local`` rings of 64 slots, so the 2 decode steps after it write slots
0 and 1 of the ring), a Cache-Craft step of 16 active positions against
a full-length prefilled cache (where the config takes chunk caches, as
the dry-run applies it), 2 decode steps. Train: 4 rows of 32 tokens, 2
microbatches, 3 AdamW steps. Weights come from a seed (the port's init,
its zero-initialised norm scales and cross-attention gates drawn from
numpy), rounded to bf16; inputs from numpy.

The reference runs once, jitted (GSPMD on its own layouts for the mesh
cases), in subprocesses with 8 forced host devices started with the
module's first test, while this process runs the tests that need nothing
of it and the port's side. Each serving step is held on the same inputs
as the reference's: the prefill from an empty cache, decode step i on
the reference's bf16 cache after step i - 1, the Cache-Craft step on its
full-length bf16 prefill; the yardstick is the reference's fp32 step on
those inputs upcast.

**The bf16 rule.** The two frameworks round bf16 in different places
(the order of the fp32 sums before a cast, whether a product is fused;
JAX's bf16 ``silu`` and ``softplus`` round their intermediates, torch's
once), so the fp32 parity standard (2e-4) cannot hold: one bf16 ulp at
the logit scale here (3) is 2^-6. The yardstick is the reference's own
bf16-vs-fp32 gap on the same inputs, its fp32 step on the same
bf16-rounded weights (fp32 caches, fp32 activations):

* logits and every floating cache leaf of each step: the rms of the
  port's gap to the reference's bf16 value within ``GAP_FACTOR`` (2)
  times the rms of the reference's bf16-vs-fp32 gap, and the largest gap
  within ``GAP_FACTOR`` times the reference's largest plus one bf16 ulp
  of the value's largest magnitude; positions equal, dtypes equal. Why
  rms, and why the ulp: a value rounded once lies within half an ulp of
  its fp32 value, and two roundings of values a hair apart land a whole
  ulp apart, so the ratio of the largest gaps sits at 2 for a single
  rounding and the largest-gap form alone read 2.0-2.3 on the sharded
  caches of llama3-8b and recurrentgemma-9b (v, k, conv, h at one ulp
  where the reference's gap was just under half); the rms averages over
  the leaf and reads 1.28-1.68 at worst for each dense arch here;
* mamba2-370m (ROADMAP C10: its random layers amplify rounding) passes
  also within ``DRIFT_FACTOR`` (4) times the most of three reference bf16
  runs from its embedding moved by about one bf16 rounding (``CONTROL``),
  as the repo holds it elsewhere: its decode step read 2.0-3.4 times the
  reference's gap on the rms and largest forms alike, and the ratio of
  the port's to the reference's bf16-vs-fp32 gap ran 0.53-4.46 over 16
  decode steps (0.45-3.6 with JAX's rounding of ``silu`` and ``softplus``
  copied; llama3-8b's 0.72-1.21); its bf16 train step's grad norm moved
  from 81.6 to 300.5 between steps in the reference alone, and by up to
  188 under the controls;
* train steps: the losses within ``GAP_FACTOR`` times the reference's
  per-token bf16-vs-fp32 NLL gap (the mean over tokens of |NLL16 -
  NLL32| of its train-mode forward at the initial params on the first
  batch). A loss is a mean of per-token NLLs whose bf16 errors cancel in
  the mean by chance, so its own bf16-vs-fp32 gap is no scale: at step
  0 of tiny llama3-8b the reference's is 3.4e-4 and the port's 1.46e-3
  on one batch, and over six batches the ratio of the two ran from 0.97
  to 12 with either sign. The per-token gap is what the mean would move
  with no cancellation. The grad norms likewise within ``GAP_FACTOR``
  times the norm of the reference's bf16-vs-fp32 grad gap at the initial
  params (``|norm(a) - norm(b)| <= norm(a - b)``; the norms' own gaps read
  0.2-3.6 times each other). The bf16 params: the share of elements
  beyond one bf16 ulp of the reference's within ``GAP_FACTOR`` times the
  share at which the reference's own fp32 params (rounded to bf16) leave
  one ulp of its bf16 ones, and the largest gap within ``GAP_FACTOR``
  times the reference's largest. An AdamW update of ~lr is several ulps
  of a small param, and where m / sqrt(v) differs in sign between two
  roundings of a grad near zero the two updates part by up to 2 lr; the
  port leaves one ulp at 3-8% of the elements, the reference's own fp32
  run at 3-7% (mamba2 38-52% both). The fp32 moments ``m`` and ``v`` by
  the first rule against the reference's bf16-vs-fp32 gap of each: they
  are the grads' running averages, so their gap is the grad gap carried
  through the same update;
* MoE (ROADMAP C13): the reference's bf16 MoE cannot run on XLA:CPU
  (``moe_ffn``'s bf16 x bf16 -> fp32 products: "Unsupported element type
  for DotThunk::Execute"). Its error is asserted, so that a jax that
  mends it fails here and the test becomes a parity test. The port's
  bf16 MoE models are held instead against the port's fp32 run on the
  same bf16-rounded weights that replays the bf16 run's expert ids per
  layer and token (its gates from its own probs at those ids): a
  continuous function of the same inputs, within ``GAP_FACTOR`` times
  the largest reference bf16-vs-fp32 gap of the dense-FFN families at
  the same tiny widths. The route flips are counted as A21 counts them
  (tokens whose top-k expert set differs between the bf16 run and the
  fp32 run's own choice under the same upstream routes) and bounded:
  each must lie at a near tie, its fp32 top-k margin within twice the
  largest bf16-vs-fp32 router-probability gap of the tokens that agree.
  The port's fp32 run with its own routes is held to the reference's
  fp32 run at the parity standard (2e-4).

Every gap and its yardstick prints under ``pytest -s``. No factor was
changed after a reading; the rms form, the ulp, the per-token and grad
yardsticks and mamba2's controls were each added after the readings
above showed the single-sample form at the edge of its own noise.
"""
import collections
import functools
import json
import os
import subprocess
import sys
import textwrap

import ml_dtypes
import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, get_tiny
from repro_torch.distributed import sharding as SH
from repro_torch.launch import dryrun as DR
from repro_torch.launch import roofline as RL
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import model as TM
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import steps as TS
from repro_torch.training.optimizer import AdamWConfig, tree_leaves

torch.set_num_threads(2)
CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16 = dict(dtype="bfloat16", param_dtype="bfloat16")
GAP_FACTOR = 2.0
PARITY = dict(rtol=2e-4, atol=2e-4)       # fp32, port against reference
B, T, S, A, DECODE = 2, 64, 72, 16, 2
TB, TT, STEPS = 4, 32, 3                  # train: rows, tokens, steps
OPT = dict(peak_lr=1e-3, warmup_steps=2, total_steps=20)
MOE = ("granite-moe-1b-a400m", "phi3.5-moe-42b-a6.6b")
DENSE = tuple(a for a in ARCHS if a not in MOE)
ROOT_ARCHS = DENSE + MOE
SHARDED = ("llama3-8b", "recurrentgemma-9b", "mamba2-370m")
TRAIN_ARCHS = SHARDED + ("gemma3-4b", "llama-3.2-vision-90b",
                         "musicgen-medium")
MESHES = ((1, 4), (2, 2))
IMPLS = ("auto", "kernel")
C13_ERROR = "Unsupported element type for DotThunk::Execute"
# the family whose random layers amplify rounding (ROADMAP C10): held
# also to DRIFT_FACTOR x the most of the reference's bf16 runs from its
# embedding moved by about one bf16 rounding (CONTROL, seeds SEEDS)
DRIFT = ("mamba2-370m",)
DRIFT_FACTOR = 4.0
SEEDS = (1, 2, 3)
CONTROL = 2.0 ** -8
STEP_WHATS = ("prefill",) + tuple(f"decode{i}" for i in range(DECODE)) + \
    ("cc",)


def _mesh_tag(shape):
    return f"{shape[0]}x{shape[1]}"


# ---------------------------------------------------------------------------
# weights and inputs, numpy
# ---------------------------------------------------------------------------
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


def _tree(flat):
    """``_flat``'s inverse for a params, cache or state tree."""
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
    return tree


def _params_tree(flat):
    tree = _tree(flat)
    tree.setdefault("groups", [])
    tree.setdefault("tail", [])
    return tree


@functools.lru_cache(maxsize=None)
def weights(arch):
    """The params as numpy fp32 holding bf16 values, from a seed: the
    port's init, the norm scales (zero at init) and ``xattn``'s gates
    (zero at init, the layer the identity) drawn from numpy."""
    cfg = get_tiny(arch)
    params = TM.init_params(cfg, torch.Generator().manual_seed(11))
    rng = np.random.default_rng(12)
    flat = {k: v.detach().numpy().copy() for k, v in _flat(params).items()}
    for k, v in flat.items():
        name = k.rsplit("/", 1)[-1]
        if name in ("ln1", "ln2", "final_norm", "out_norm"):
            flat[k] = rng.normal(0, 0.3, v.shape).astype(np.float32)
        elif name in ("gate_attn", "gate_ffn"):
            flat[k] = rng.uniform(0.5, 1.0, v.shape).astype(np.float32)
    return {k: v.astype(ml_dtypes.bfloat16).astype(np.float32)
            for k, v in flat.items()}


@functools.lru_cache(maxsize=None)
def inputs(arch):
    """Numpy inputs of the serving steps and the train steps."""
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
    for i in range(STEPS):
        out[f"labels{i}"] = rng.integers(0, cfg.vocab_size, (TB, TT)).astype(
            np.int32)
        if cfg.input_mode == "embeds":
            out[f"tembeds{i}"] = rng.normal(size=(TB, TT, cfg.d_model)
                                            ).astype(np.float32)
        else:
            out[f"ttokens{i}"] = rng.integers(0, cfg.vocab_size,
                                              (TB, TT)).astype(np.int32)
        if cfg.num_media_tokens:
            out[f"tmedia{i}"] = rng.normal(size=(TB, cfg.num_media_tokens,
                                                 cfg.d_model)).astype(
                np.float32)
    return out


def _train_batch(arch, i):
    """Train batch ``i`` as numpy: tokens or embeds, labels, media."""
    x = inputs(arch)
    b = {"labels": x[f"labels{i}"]}
    for k in ("tokens", "embeds", "media"):
        if f"t{k}{i}" in x:
            b[k] = x[f"t{k}{i}"]
    return b


# ---------------------------------------------------------------------------
# the reference, in subprocesses
# ---------------------------------------------------------------------------
REF_CODE = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_tiny
from repro.distributed import sharding as SH
from repro.launch.dryrun import _batch_axis, cache_shardings
from repro.launch.mesh import data_axes, dp_size, make_debug_mesh
from repro.models import model as M
from repro.training import steps as JS
from repro.training.optimizer import AdamWConfig, adamw_init
# the reference's dry-run module asks for 512 devices when imported; the
# backend starts at the first device query, so ask for 8 again first
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
assert len(jax.devices()) == 8
OUT, TASKS, NAME = sys.argv[1], json.loads(sys.argv[2]), sys.argv[3]
(B, T, S, A, DECODE, TB, TT, STEPS, OPT, DRIFT, SEEDS, CONTROL,
 MESHES) = CONSTS
BF16 = dict(dtype="bfloat16", param_dtype="bfloat16")
res, meta = {}, {}


def f32(x):
    # a copy: a host view of a step's output can be handed to the next
    # step as its input buffer
    a = np.array(x, copy=True)
    return a if np.issubdtype(a.dtype, np.integer) else a.astype(np.float32)


def tree(flat, dt):
    out = {"groups": [], "tail": []}
    for k, v in flat.items():
        parts = k.split("/")
        if len(parts) == 1:
            out[k] = jnp.asarray(v, dt)
            continue
        lst = out[parts[0]]
        i = int(parts[1])
        while len(lst) <= i:
            lst.append({})
        lst[i][parts[2]] = jnp.asarray(v, dt)
    return out


def flat(t, prefix=""):
    if isinstance(t, dict):
        items = t.items()
    elif isinstance(t, (list, tuple)):
        items = enumerate(t)
    else:
        return {prefix: t}
    o = {}
    for k, v in items:
        o.update(flat(v, f"{prefix}/{k}" if prefix else str(k)))
    return o


def save(tag, logits=None, cache=None):
    if logits is not None:
        res[tag + "|logits"] = f32(logits)
    for k, v in flat(cache or {}).items():
        res[f"{tag}|cache|{k}"] = f32(v)
        meta[f"{tag}|dtype|{k}"] = str(jnp.asarray(v).dtype)


def cast(b, dt):
    return {k: jnp.asarray(v, dt) if k in ("embeds", "media")
            else jnp.asarray(v) for k, v in b.items()}


def steps(cfg, impl):
    dec = JS.make_decode_step(cfg) if impl == "auto" else (
        lambda p, b: (lambda o: (o.logits, o.cache))(M.decode_step(
            cfg, p, b["tokens"], b["positions"], b["cache"],
            attn_impl=impl)))
    return (JS.make_prefill_step(cfg, impl),
            JS.make_cachecraft_prefill_step(cfg, impl), dec)


def batches(cfg, x, rows, dt):
    key = "embeds" if cfg.input_mode == "embeds" else "tokens"
    media = {"media": x["media"][:rows]} if "media" in x else {}
    pre = cast({key: x[key][:rows], **media}, dt)
    cc = cast({key: x["cc_" + key][:rows],
               "positions": x["cc_positions"][:rows], **media}, dt)
    dec = [cast({"tokens": x["dec_tokens"][i, :rows],
                 "positions": np.full((rows,), T + i, np.int32)}, dt)
           for i in range(DECODE)]
    return pre, cc, dec


def layout(cfg, mesh, kind, batch):
    b_ax = _batch_axis(mesh, B)
    rules = SH.make_rules(mesh, cfg, batch_shard=b_ax is not None)
    bspec = NamedSharding(mesh, P(b_ax) if b_ax else P())
    with mesh, SH.axis_rules(rules):
        pspecs = SH.spec_tree(M.param_axes(cfg))
    psh = jax.tree.map(lambda s: NamedSharding(mesh, s), pspecs,
                       is_leaf=lambda x: isinstance(x, P))
    csh = cache_shardings(cfg, mesh, batch["cache"], B, kind=kind)
    return rules, psh, {k: csh if k == "cache" else bspec for k in batch}


JITS = {}


def jitted(cfg, impl):
    key = (cfg.name, cfg.dtype, impl)
    if key not in JITS:
        JITS[key] = tuple(jax.jit(f) for f in steps(cfg, impl))
    return JITS[key]


def up(cache):
    return jax.tree.map(lambda v: jnp.asarray(np.asarray(v)).astype(
        jnp.float32) if jnp.issubdtype(v.dtype, jnp.floating) else v, cache)


def serve(tag, cfg, params, x, impl, shape=None, yard=None, feed=None):
    # the three steps, each fed the state the one before it left: the
    # prefill into an empty ring cache, each decode step on the cache
    # before it, the Cache-Craft step on the full-length prefill's cache
    # (as the dry-run applies it). yard = (fp32 config, fp32 params): the
    # fp32 step on auto on the same inputs (the caches upcast), unsharded.
    # feed = (states, full) of another chain: each step fed those instead
    dt = jnp.dtype(cfg.dtype)
    pre, cc, dec = batches(cfg, x, B, dt)
    fp, fc, fd = steps(cfg, impl)

    def run(fn, kind, b):
        if shape is None:
            return jitted(cfg, impl)[("prefill", "cc", "decode").index(
                kind)](params, b)
        mesh = make_debug_mesh(shape)
        rules, psh, bsh = layout(cfg, mesh, "prefill" if kind == "cc"
                                 else kind, b)
        key = (cfg.name, impl, kind, shape)
        with mesh, SH.axis_rules(rules):
            if key not in JITS:
                JITS[key] = jax.jit(fn, in_shardings=(psh, bsh))
            return JITS[key](params, b)

    lg, c = run(fp, "prefill", dict(pre, cache=M.init_cache(
        cfg, B, S, dtype=dt, ring=True)))
    save(tag + "|prefill", lg, c)
    states = [c]
    for i, d in enumerate(dec):
        if feed is not None:
            c = feed[0][i]
        # from the host: the step's output comes back in GSPMD's layout
        lg, c = run(fd, "decode", dict(d, cache=jax.tree.map(np.array, c)))
        save(f"{tag}|decode{i}", lg, c)
        states.append(c)
    full = None
    if cfg.supports_chunk_cache:
        full = feed[1] if feed is not None else jitted(cfg, impl)[0](
            params, dict(pre, cache=M.init_cache(cfg, B, S, dtype=dt,
                                                 ring=False)))[1]
        save(tag + "|full", None, full)
        lg, c = run(fc, "cc", dict(cc, cache=full))
        save(tag + "|cc", lg, c)
    if yard is None:
        return states, full
    cfg32, p32 = yard
    tag32 = tag.rsplit("|", 1)[0] + "|yard"
    fp32, fc32, fd32 = jitted(cfg32, "auto")
    pre, cc, dec = batches(cfg32, x, B, jnp.float32)
    lg, c = fp32(p32, dict(pre, cache=M.init_cache(
        cfg32, B, S, dtype=jnp.float32, ring=True)))
    save(tag32 + "|prefill", lg, c)
    for i, d in enumerate(dec):
        lg, c = fd32(p32, dict(d, cache=up(states[i])))
        save(f"{tag32}|decode{i}", lg, c)
    if full is not None:
        lg, c = fc32(p32, dict(cc, cache=up(full)))
        save(tag32 + "|cc", lg, c)
    return states, full


def perturbed(w, seed):
    # the control of a model that amplifies rounding: its embedding moved
    # by about one bf16 rounding, rounded to bf16 again
    w = dict(w)
    e = w["embed"]
    noise = np.random.default_rng(seed).normal(size=e.shape)
    w["embed"] = np.asarray(jnp.asarray(e * (1 + CONTROL * noise),
                                        jnp.bfloat16).astype(jnp.float32))
    return w


def nll_and_grads(cfg):
    # the per-token NLL of the train-mode forward and the grads of its
    # mean, in one jit
    def loss(p, b):
        out = M.forward(cfg, p, tokens=b.get("tokens"),
                        embeds=b.get("embeds"), media=b.get("media"),
                        mode="train")
        logp = jax.nn.log_softmax(out.logits.astype(jnp.float32), -1)
        nll = -jnp.take_along_axis(logp, b["labels"][..., None], -1)[..., 0]
        return nll.mean() + JS.MOE_AUX_COEF * out.aux_loss, nll
    return jax.jit(jax.grad(loss, has_aux=True))


def train(tag, cfg, w, x, dt, shape=None):
    params = tree(w, dt)
    state = JS.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                          opt=adamw_init(params))
    opt = AdamWConfig(**OPT)
    tb = [cast({k[1:-1]: v for k, v in x.items()
                if k[0] == "t" and k[-1] == str(i)}
               | {"labels": x[f"labels{i}"]}, dt) for i in range(STEPS)]
    if shape is None:
        key = ("train", cfg.name, cfg.dtype)
        if key not in JITS:
            JITS[key] = jax.jit(JS.make_train_step(cfg, opt, accum=2))
        step, put, ctx = JITS[key], (lambda s: s), None
        if "|ctl" not in tag:
            # the yardsticks (the controls need none)
            grads, nll = nll_and_grads(cfg)(params, tb[0])
            res[tag + "|nll"] = f32(nll)
            for k, v in flat(grads).items():
                res[f"{tag}|grad|{k}"] = f32(v)
    else:
        mesh = make_debug_mesh(shape)
        rules = SH.make_rules(mesh, cfg)
        ctx = (mesh, rules)
        with mesh, SH.axis_rules(rules):
            pspecs = SH.spec_tree(M.param_axes(cfg))
            pshard = jax.tree.map(lambda s: NamedSharding(mesh, s), pspecs,
                                  is_leaf=lambda v: isinstance(v, P))
            zero1 = jax.tree.map(lambda s, leaf: NamedSharding(
                mesh, SH.zero1_spec(s, leaf.shape, data_axes(mesh),
                                    dp_size(mesh))),
                pspecs, state.opt["m"], is_leaf=lambda v: isinstance(v, P))
            sshard = JS.TrainState(
                step=NamedSharding(mesh, P()), params=pshard,
                opt={"m": zero1, "v": zero1,
                     "count": NamedSharding(mesh, P())})
            bsh = {k: NamedSharding(mesh, P("data")) for k in tb[0]}
            step = jax.jit(JS.make_train_step(cfg, opt, accum=2,
                                              grad_specs=zero1),
                           in_shardings=(sshard, bsh))
        put = lambda s: jax.device_put(s, sshard)
    for i, b in enumerate(tb):
        if ctx is None:
            state, m = step(state, b)
        else:
            with ctx[0], SH.axis_rules(ctx[1]):
                state, m = step(put(state), b)
        res[f"{tag}|loss{i}"] = np.float32(m["loss"])
        res[f"{tag}|gnorm{i}"] = np.float32(m["grad_norm"])
    for k, v in flat(JS.state_to_tree(state)).items():
        res[f"{tag}|state|{k}"] = f32(v)


import time
for task in TASKS:
    t0 = time.perf_counter()
    kind, arch = task[0], task[1]
    w = dict(np.load(os.path.join(OUT, f"w_{arch}.npz")))
    x = dict(np.load(os.path.join(OUT, f"in_{arch}.npz")))
    cfg32 = get_tiny(arch)
    cfg16 = cfg32.replace(**BF16)
    if kind == "roots":
        p16, p32 = tree(w, jnp.bfloat16), tree(w, jnp.float32)
        if cfg32.num_experts:
            try:
                serve(f"{arch}|auto|bf16", cfg16, p16, x, "auto")
            except Exception as e:     # ROADMAP C13
                meta[f"{arch}|bf16|error"] = f"{type(e).__name__}: {e}"[:4000]
            serve(f"{arch}|auto|fp32", cfg32, p32, x, "auto")
        else:
            for impl in ("auto", "kernel"):
                feed = serve(f"{arch}|{impl}|bf16", cfg16, p16, x, impl,
                             yard=(cfg32, p32))
                if arch in DRIFT:
                    for sd in SEEDS:
                        serve(f"{arch}|{impl}|ctl{sd}", cfg16, tree(
                            perturbed(w, sd), jnp.bfloat16), x, impl,
                            feed=feed)
    elif kind == "sharded":
        for shape in MESHES:
            tag = f"{arch}|{shape[0]}x{shape[1]}"
            serve(tag + "|bf16", cfg16, tree(w, jnp.bfloat16), x, "auto",
                  tuple(shape), yard=(cfg32, tree(w, jnp.float32)))
            train(tag + "|train|bf16", cfg16, w, x, jnp.bfloat16,
                  tuple(shape))
    elif kind == "train":
        for dname, cfg in (("bf16", cfg16), ("fp32", cfg32)):
            train(f"{arch}|train|{dname}", cfg, w, x, jnp.dtype(cfg.dtype))
        if arch in DRIFT:
            for sd in SEEDS:
                train(f"{arch}|train|ctl{sd}", cfg16, perturbed(w, sd), x,
                      jnp.bfloat16)
    print("task", task, f"{time.perf_counter() - t0:.1f}s")
np.savez(os.path.join(OUT, f"ref_{NAME}.npz"), **res)
json.dump(meta, open(os.path.join(OUT, f"meta_{NAME}.json"), "w"))
print("REF_OK")
"""
# the reference's tasks, split over REF_PROCS processes run side by side
# (their jit compiles take most of the time), the longest first onto the
# least loaded. An arch's sharded task shares a process with its roots
# task, whose unsharded compiles it reuses. REF_SECONDS: each arch's
# (roots, train, sharded) seconds as read on the test host, one task to a
# process (10 for a roots task not listed)
REF_PROCS = 4
REF_SECONDS = {"recurrentgemma-9b": (13, 33, 45), "mamba2-370m": (5, 15, 20),
               "llama3-8b": (0, 11, 23), "gemma3-4b": (22, 26, 0),
               "llama-3.2-vision-90b": (18, 26, 0),
               "musicgen-medium": (9, 12, 0), "granite-moe-1b-a400m": (6, 0, 0),
               "phi3.5-moe-42b-a6.6b": (5, 0, 0)}


def _ref_tasks():
    kinds = ("roots", "train", "sharded")
    tasks = [("roots", a) for a in ROOT_ARCHS] + \
        [("train", a) for a in TRAIN_ARCHS] + [("sharded", a) for a in SHARDED]
    groups = collections.defaultdict(list)
    for t in tasks:
        groups[t[1] if t[0] != "train" else t].append(t)

    def cost(g):
        return sum(REF_SECONDS.get(a, (10, 0, 0))[kinds.index(k)]
                   for k, a in g)
    procs = [[0, []] for _ in range(REF_PROCS)]
    for g in sorted(groups.values(), key=lambda g: -cost(g)):
        p = min(procs, key=lambda p: p[0])
        p[0] += cost(g)
        p[1] += g
    return [p[1] for p in procs]


class Reference:
    """The reference's results: started on construction, read on first
    use (``[key]``, ``meta``)."""

    def __init__(self, out):
        self.out, self.res, self.meta = out, None, None
        for arch in set(ROOT_ARCHS + TRAIN_ARCHS):
            np.savez(out / f"w_{arch}.npz", **weights(arch))
            np.savez(out / f"in_{arch}.npz", **inputs(arch))
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
        consts = repr((B, T, S, A, DECODE, TB, TT, STEPS, OPT, DRIFT,
                       SEEDS, CONTROL, MESHES))
        code = textwrap.dedent(REF_CODE.replace("CONSTS", consts))
        # each process's output to files, read at the end: a pipe that
        # nothing reads would stall a process that writes much
        self.procs = []
        for i, tasks in enumerate(_ref_tasks()):
            with open(out / f"ref_{i}.out", "w") as so, \
                    open(out / f"ref_{i}.err", "w") as se:
                self.procs.append(subprocess.Popen(
                    [sys.executable, "-c", code, str(out),
                     json.dumps(tasks), str(i)], cwd=ROOT, env=env,
                    stdout=so, stderr=se))

    def _wait(self):
        if self.res is not None:
            return
        res, meta = {}, {}
        for i, pr in enumerate(self.procs):
            pr.wait(timeout=1200)
            so = (self.out / f"ref_{i}.out").read_text()
            se = (self.out / f"ref_{i}.err").read_text()
            assert pr.returncode == 0, se[-4000:]
            assert "REF_OK" in so
            print(so)
            res.update(np.load(self.out / f"ref_{i}.npz"))
            meta.update(json.load(open(self.out / f"meta_{i}.json")))
        self.res, self.meta = res, meta

    def __getitem__(self, key):
        self._wait()
        return self.res[key]

    @property
    def res_keys(self):
        self._wait()
        return self.res

    def get_meta(self, key):
        self._wait()
        return self.meta.get(key)

    def _cache(self, prefix, typed=False):
        """The cache saved under ``prefix``; ``typed``: each leaf in the
        dtype the reference held it in."""
        out = {k[len(prefix) + 6:]: v for k, v in self.res.items()
               if k.startswith(prefix + "cache|")}
        if typed:
            out = {k: v.astype(ml_dtypes.bfloat16) if self.meta[
                f"{prefix}dtype|{k}"] == "bfloat16" else v
                for k, v in out.items()}
        return out

    def step(self, tag):
        """{step: (logits, {leaf: array})} of the serving steps under
        ``tag``."""
        self._wait()
        return {what: (self.res[f"{tag}|{what}|logits"],
                       self._cache(f"{tag}|{what}|"))
                for what in STEP_WHATS
                if f"{tag}|{what}|logits" in self.res}

    def states(self, tag):
        """The caches each step of ``tag`` was fed: {step: {leaf: array}}
        (the prefill's, each decode step's, the full-length prefill's)."""
        self._wait()
        out = {"decode0": self._cache(f"{tag}|prefill|", True)}
        for i in range(1, DECODE):
            out[f"decode{i}"] = self._cache(f"{tag}|decode{i - 1}|", True)
        full = self._cache(f"{tag}|full|", True)
        if full:
            out["cc"] = full
        return out


@pytest.fixture(scope="module", autouse=True)
def started(tmp_path_factory):
    """The reference's subprocesses, started with the module's first test,
    so that the tests that need nothing of them run while they compile."""
    r = Reference(tmp_path_factory.mktemp("ref_bf16"))
    yield r
    for pr in r.procs:
        if pr.poll() is None:
            pr.kill()


@pytest.fixture(scope="module")
def ref(started):
    r = started
    # the port's side that needs nothing of the reference runs while the
    # reference's subprocesses compile
    for arch in DENSE:
        for impl in IMPLS:
            port_prefill(arch, impl)
    for arch in TRAIN_ARCHS:
        port_train(arch)
    for arch in SHARDED:
        for shape in MESHES:
            port_train(arch, shape)
    return r


# ---------------------------------------------------------------------------
# the port
# ---------------------------------------------------------------------------
def _t(x, dt=None):
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t.to(dt) if dt is not None and t.is_floating_point() else t


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return x.numpy().copy() if not x.is_floating_point() else \
            x.float().numpy().copy()
    return np.asarray(x)


def _cfg(arch, bf16=True):
    cfg = get_tiny(arch)
    return cfg.replace(**BF16) if bf16 else cfg


def _params(arch, bf16=True):
    cfg = _cfg(arch, bf16)
    dt = ml_dtypes.bfloat16 if bf16 else np.float32
    return TM.params_from_jax(cfg, _params_tree(
        {k: v.astype(dt) for k, v in weights(arch).items()}), CPU)


def _batches(arch, dt, rows=B):
    cfg = get_tiny(arch)
    x = inputs(arch)
    media = {"media": _t(x["media"][:rows], dt)} if "media" in x else {}
    key = "embeds" if cfg.input_mode == "embeds" else "tokens"
    pre = {key: _t(x[key][:rows], dt), **media}
    cc = {key: _t(x["cc_" + key][:rows], dt),
          "positions": _t(x["cc_positions"][:rows]), **media}
    dec = [{"tokens": _t(x["dec_tokens"][i, :rows]),
            "positions": torch.full((rows,), T + i, dtype=torch.int32)}
           for i in range(DECODE)]
    return pre, cc, dec


def _torch(a):
    """A copy of numpy ``a`` as a tensor (bf16 from ``ml_dtypes``)."""
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(a.copy())


def _tensors(flat, up=False):
    """A flat numpy cache as a tree of tensors, each leaf a copy in its
    own dtype (``up``: floating leaves upcast to fp32)."""
    return _params_tree({k: _torch(v).float() if up and v.dtype.kind in
                         "fV" else _torch(v) for k, v in flat.items()})


def run_steps(cfg, params, arch, impl, shape=None, states=None,
              only=None, on_step=None):
    """The port's serving steps on ``impl`` as the reference's ``serve``
    runs them: the prefill into an empty cache, decode step i on
    ``states["decode<i>"]``, the Cache-Craft step on ``states["cc"]``
    (flat numpy caches, the reference's; None: the port's own chain).
    With ``shape`` on that (data, model) mesh. ``only``: the steps to run;
    ``on_step(what)`` is called before each (``"full"``: the full-length
    prefill of the port's own chain).
    Returns {step: (logits, {leaf: array})}, "dtypes" {leaf: dtype} of the
    prefill's cache and "states" (the caches each step was fed)."""
    dt = TM.torch_dtype(cfg.dtype)
    pre, cc, dec = _batches(arch, dt)
    mesh = None if shape is None else make_debug_mesh(shape, device=CPU)
    out, fed = {}, {}

    def run(what, mode, maker, cache, b):
        if on_step is not None:
            on_step(what)
        fed[what] = {k: _np(v) for k, v in _flat(cache).items()}
        if mesh is None:
            step, p, c = maker(cfg, impl), params, cache
        else:
            shs = DR.serving_shardings(cfg, mode, B, S, mesh)
            step, p = maker(cfg, impl, shardings=shs), \
                SH.shard_tree(params, shs[0])
            c = SH.shard_tree(cache, shs[1]["cache"])
        lg, c = step(p, dict(b, cache=c))
        whole = c if mesh is None else SH.unshard_tree(c)
        out[what] = (_np(lg), {k: _np(v) for k, v in _flat(whole).items()})
        return whole

    def given(what, own):
        if states is None:
            return own
        return _tensors(states[what], up=dt == torch.float32)

    cache = None
    if only is None or "prefill" in only:
        cache = run("prefill", "prefill", TS.make_prefill_step,
                    TM.init_cache(cfg, B, S, device=CPU), pre)
        out["dtypes"] = {k: str(v.dtype).replace("torch.", "")
                         for k, v in _flat(cache).items()}
    for i, d in enumerate(dec):
        what = f"decode{i}"
        if only is None or what in only:
            cache = run(what, "decode", TS.make_decode_step,
                        given(what, cache), d)
    if cfg.supports_chunk_cache and (only is None or "cc" in only):
        full = None
        if states is None:
            full = TM.init_cache(cfg, B, S, device=CPU, ring=False)
            if on_step is not None:
                on_step("full")
            TS.make_prefill_step(cfg, impl)(params, dict(pre, cache=full))
        run("cc", "partial", TS.make_cachecraft_prefill_step,
            given("cc", full), cc)
    out["states"] = fed
    return out


@functools.lru_cache(maxsize=None)
def port_prefill(arch, impl, shape=None):
    return run_steps(_cfg(arch), _params(arch), arch, impl, shape,
                     only=("prefill",))


def port_steps(ref, arch, impl, shape=None):
    """The port's bf16 steps, the prefill from an empty cache, the others
    fed the reference's bf16 states of the same route (``auto`` on a
    mesh)."""
    tag = f"{arch}|{impl}|bf16" if shape is None else \
        f"{arch}|{_mesh_tag(shape)}|bf16"
    got = dict(port_prefill(arch, impl, shape))
    rest = run_steps(_cfg(arch), _params(arch), arch, impl, shape,
                     states=ref.states(tag),
                     only=tuple(w for w in STEP_WHATS if w != "prefill"))
    got.update({k: v for k, v in rest.items() if k != "states"})
    return got, tag


def _state_tree(arch, dt):
    w = {k: v.astype(dt) for k, v in weights(arch).items()}
    zeros = {k: np.zeros(v.shape, np.float32) for k, v in w.items()}
    return {"step": np.int32(0), "params": _params_tree(w),
            "opt": {"m": _params_tree(zeros), "v": _params_tree(zeros),
                    "count": np.int32(0)}}


@functools.lru_cache(maxsize=None)
def port_train(arch, shape=None):
    """3 bf16 train steps (accum 2): losses, grad norms and the state's
    leaves as numpy, by ``jax.tree.leaves`` path."""
    cfg = _cfg(arch)
    state = TS.state_from_jax(cfg, _state_tree(arch, ml_dtypes.bfloat16),
                              CPU)
    assert all(p.dtype == torch.bfloat16 for p in tree_leaves(state.params))
    assert all(m.dtype == torch.float32 for m in tree_leaves(state.opt["m"]))
    opt = AdamWConfig(**OPT)
    if shape is None:
        step = TS.make_train_step(cfg, opt, accum=2)
    else:
        shs = TS.train_shardings(cfg, make_debug_mesh(shape, device=CPU))
        state = TS.shard_state(state, shs)
        step = TS.make_train_step(cfg, opt, accum=2,
                                  grad_specs=shs["opt"]["m"])
    losses, gnorms = [], []
    for i in range(STEPS):
        b = {k: _t(v, torch.bfloat16) for k, v in
             _train_batch(arch, i).items()}
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    if shape is not None:
        state = TS.unshard_state(state)
    assert all(p.dtype == torch.bfloat16 for p in tree_leaves(state.params))
    leaves = {k: _np(v) for k, v in _flat(TS.state_to_tree(state)).items()}
    return dict(losses=losses, gnorms=gnorms, state=leaves,
                dtypes={k: v.dtype for k, v in
                        _flat(TS.state_to_tree(state)).items()})


# ---------------------------------------------------------------------------
# the rule
# ---------------------------------------------------------------------------
def _gap(a, b):
    return float(np.abs(np.asarray(a, np.float32) -
                        np.asarray(b, np.float32)).max())


def _rms(a, b):
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return float(np.sqrt(np.mean(d * d)))


def _top_ulp(x):
    """One bf16 ulp at the largest magnitude of ``x``."""
    top = np.abs(np.asarray(x, np.float32)).max()
    return float(_ulp(np.array([top]))[0])


def held(got, ref16, ref32, controls=()):
    """The bf16 rule on one value: the rms gap to the reference's bf16
    value within GAP_FACTOR x the reference's own rms bf16-vs-fp32 gap,
    and the largest within GAP_FACTOR x the reference's largest plus one
    bf16 ulp of the value's largest magnitude (two bf16 roundings of
    nearly equal values land up to one ulp apart where one rounding lands
    half an ulp from the fp32 value). With ``controls`` (a DRIFT model,
    the reference's bf16 values from the perturbed embeddings) either
    that, or the same with DRIFT_FACTOR x the most of the controls' gaps
    to the reference's bf16 value. Returns (ok, rms gap, the yardstick's
    rms gap, max gap, the yardstick's max gap)."""
    g, r = _rms(got, ref16), _rms(ref16, ref32)
    gm, rm = _gap(got, ref16), _gap(ref16, ref32)
    ulp = _top_ulp(ref16)
    ok = g <= GAP_FACTOR * r and gm <= GAP_FACTOR * rm + ulp
    if controls and not ok:
        r = max(_rms(c, ref16) for c in controls)
        rm = max(_gap(c, ref16) for c in controls)
        ok = g <= DRIFT_FACTOR * r and gm <= DRIFT_FACTOR * rm + ulp
    return ok, g, r, gm, rm


def hold_steps(tag, got, ref16, ref32, controls=()):
    """Every step's logits and floating cache leaves by the bf16 rule
    (``held``; ``controls``: a DRIFT model's control runs, each like
    ``ref16``); shapes equal, integer leaves equal. Returns {name: (rms
    gap, the yardstick's)} and prints it."""
    gaps, bad = {}, []
    assert set(ref16) == set(ref32) and set(ref16) <= set(got), tag
    for what, (lg16, c16) in ref16.items():
        lg, cache = got[what]
        lg32, c32 = ref32[what]
        ctl = [c[what] for c in controls]
        pairs = [("logits", lg, lg16, lg32, [c[0] for c in ctl])]
        assert set(cache) == set(c16) == set(c32), (tag, what)
        for k, v in c16.items():
            if np.issubdtype(v.dtype, np.integer):
                assert np.array_equal(cache[k], v), (tag, what, k)
                assert np.array_equal(c32[k], v), (tag, what, k)
            else:
                pairs.append((k, cache[k], v, c32[k],
                              [c[1][k] for c in ctl]))
        for name, a, b, c, cs in pairs:
            assert a.shape == b.shape == c.shape, (tag, what, name)
            ok, g, r, gm, rm = held(a, b, c, cs)
            gaps[f"{what} {name}"] = (g, r)
            if not ok:
                bad.append((what, name, g, r, gm, rm))
    print(f"{tag}: port vs reference bf16, rms (yardstick): "
          + ", ".join(f"{n} {g:.2e} ({r:.2e})" for n, (g, r) in
                      gaps.items()))
    assert not bad, (tag, bad)
    return gaps


def _controls(ref, arch, impl):
    if arch not in DRIFT:
        return ()
    return [ref.step(f"{arch}|{impl}|ctl{sd}") for sd in SEEDS]


def _ring_slots(cfg, cache):
    """A ``local`` layer's ring after the decode steps holds position p at
    slot p % window (its ``min(S, window)`` slots)."""
    for i, kind in enumerate(cfg.pattern):
        if kind != "local":
            continue
        pos = cache[f"groups/{i}/pos"]
        n = pos.shape[-1]
        assert n == min(S, cfg.window)
        for p in (T - 1, T, T + DECODE - 1):
            assert (pos[..., p % n] == p).all(), (i, p)


# ---------------------------------------------------------------------------
# checkpoints (C13) and the roofline
# ---------------------------------------------------------------------------
def test_bf16_checkpoint_refused_beside_reference_bytes(tmp_path):
    """C13: the reference stores a bf16 leaf with ``np.asarray`` and gets
    it back as 2-byte void (``|V2``), not bf16; the port, which adds no
    feature the reference lacks, refuses to save a bf16 leaf."""
    code = textwrap.dedent(f"""
        import jax.numpy as jnp, numpy as np
        from repro.training import checkpoint as ckpt
        x = jnp.asarray([1.5, -2.25, 3.0], jnp.bfloat16)
        ckpt.save({{"w": x, "n": jnp.asarray([1.0], jnp.float32)}},
                  {str(tmp_path / "ref")!r}, 0)
        back = ckpt.restore({str(tmp_path / "ref")!r}, step=0)
        print(back["w"].dtype.str, back["n"].dtype.str,
              back["w"].view(np.uint16).tolist(),
              np.asarray(x).view(np.uint16).tolist())
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    wdt, ndt, got, want = out.stdout.split(maxsplit=2)[0:2] + \
        [json.loads(x) for x in
         out.stdout.split(maxsplit=2)[2].replace("] [", "]|[").split("|")]
    assert wdt == "|V2" and ndt == "<f4" and got == want
    tree = {"w": torch.tensor([1.5, -2.25, 3.0], dtype=torch.bfloat16),
            "n": torch.tensor([1.0])}
    with pytest.raises(TypeError, match="BFloat16"):
        ckpt.save(tree, str(tmp_path / "port"), 0)
    assert ckpt.latest_step(str(tmp_path / "port")) is None
    ckpt.save({"n": tree["n"]}, str(tmp_path / "port"), 0)
    assert ckpt.restore(str(tmp_path / "port"), step=0)["n"].dtype == \
        np.float32


def test_roofline_counts_bf16_train_step():
    """The bf16 train step's FLOPs on meta equal the fp32 step's (the
    products are the same), and its MFU is taken against the bf16 peak:
    ``model_flops_6nd`` over a step time over
    ``PEAK_FLOPS_BY_TYPE["bfloat16"]``."""
    counts = {}
    for bf16 in (True, False):
        cfg = _cfg("llama3-8b", bf16)
        state = DR._meta_state(cfg)
        assert next(tree_leaves(state.params)).dtype == (
            torch.bfloat16 if bf16 else torch.float32)
        step = TS.make_train_step(cfg, AdamWConfig(**OPT), accum=2)
        b = {"tokens": torch.zeros((TB, TT), dtype=torch.int32,
                                   device="meta"),
             "labels": torch.zeros((TB, TT), dtype=torch.int32,
                                   device="meta")}
        counts[bf16] = RL.count_step(step, state, b).flops
    assert counts[True] == counts[False] > 0
    assert RL.PEAK_FLOPS_BY_TYPE["bfloat16"] == RL.PEAK_FLOPS


# ---------------------------------------------------------------------------
# chip_smoke.py's phase 20, rehearsed on the CPU
# ---------------------------------------------------------------------------
class _Event:
    def record(self):
        pass

    def elapsed_time(self, other):
        return 1.0


def _rehearse(monkeypatch, planted=None):
    """chip_smoke's phase 20 made to run on the CPU: ``get_config`` giving
    the tiny configs, the card's timers and memory counters stubbed, the
    chunk, decode and SSD wrappers routed through their launch hooks onto
    the plain versions, each counting its launches by instantiation as on
    the card. ``planted``: "decode" zeroes the bf16 decode output,
    "ssd" moves the SSD kernel's stand-in's intra-chunk output by 1e-3 of
    its scale (a fault of the kernel alone, its plain version untouched).
    Returns the ``chip_smoke`` module."""
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from repro_torch import configs as C
    from repro_torch.kernels import build
    from repro_torch.kernels.chunk_attention import ops as cops
    from repro_torch.kernels.chunk_attention.ref import chunk_attention_ref
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.decode_attention.ref import \
        decode_attention_ref
    from repro_torch.kernels.ssd import ops as sops
    from repro_torch.kernels.ssd.ref import ssd_intra_ref

    def chunk_launch(q, k, v, q_pos, k_pos, k_chunk, q_seg, k_seg, C_,
                     window):
        outs = [chunk_attention_ref(q[b], k[b], v[b], q_pos[b], k_pos[b],
                                    k_chunk[b], num_chunks=C_, window=window,
                                    q_seg=q_seg[b], k_seg=k_seg[b])
                for b in range(q.shape[0])]
        f = cops.chunk_attention
        f.launches += 1
        f.launches_by_type[build.ATTN_TYPE_NAMES[
            build.attn_type_code("chunk", q, k, v)]] += 1
        return (torch.stack([o for o, _ in outs]),
                torch.stack([m for _, m in outs]))

    def chunk_attention(q, k, v, q_pos, k_pos, k_chunk, *, q_seg=None,
                        k_seg=None, num_chunks=16, window=0):
        return cops._launch(
            q, k, v, q_pos, k_pos, k_chunk,
            torch.zeros_like(q_pos) if q_seg is None else q_seg,
            torch.zeros_like(k_pos) if k_seg is None else k_seg,
            num_chunks, window)

    def call(what, entry, ptrs, ints, q, nsplit):
        return decode_attention_ref(*ptrs, window=ints[-1])

    def decode_attention(q, k, v, q_pos, k_pos, *, window=0):
        B_, H, D = q.shape
        decode_attention.launches += 1
        decode_attention.launches_by_type[build.ATTN_TYPE_NAMES[
            build.attn_type_code("decode", q, k, v)]] += 1
        out = dops._call("decode_attention", "decode_attention_fwd",
                         (q, k, v, q_pos, k_pos),
                         (B_, k.shape[1], H, k.shape[2], D, int(window)),
                         q, 1)
        if planted == "decode" and q.dtype == torch.bfloat16:
            out = torch.zeros_like(out)
        return out

    def ssd_intra(xdt, log_a, B_mat, C_mat):
        ssd_intra.launches += 1
        ssd_intra.launches_by_type[str(xdt.dtype).replace("torch.", "")] += 1
        lead = xdt.shape[:-4]
        args = [t.flatten(0, 1) if lead else t
                for t in (xdt, log_a, B_mat, C_mat)]
        y, st = ssd_intra_ref(*args)
        if planted == "ssd":
            y = y + 1e-3 * y.abs().max()
        if lead:
            y, st = y.unflatten(0, (lead[0], -1)), st.unflatten(
                0, (lead[0], -1))
        return y, st

    for f in (decode_attention, ssd_intra):
        f.launches, f.launches_by_type = 0, collections.Counter()
    chunk_attention.launches = 0
    chunk_attention.launches_by_type = collections.Counter()
    monkeypatch.setattr(C, "get_config", get_tiny)
    monkeypatch.setattr(cs, "cuda_ms", lambda fn, iters=20, warmup=3:
                        (fn(), 1.0)[1])
    monkeypatch.setattr(cs, "device_ms", lambda fn, iters=20, warmup=3,
                        windows=3: (fn(), 1.0)[1])
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats",
                        lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda *a, **k: 0)
    monkeypatch.setattr(torch.cuda, "Event", lambda **k: _Event())
    # the prompts and the train step's shape cut for the CPU
    monkeypatch.setattr(cs, "TRAIN_SEQ", 128)
    monkeypatch.setattr(cs, "SERVE_TOKENS", 96)
    monkeypatch.setattr(cs, "SERVE_CACHE", 104)
    monkeypatch.setattr(cops, "_launch", chunk_launch)
    monkeypatch.setattr(cops, "chunk_attention", chunk_attention)
    monkeypatch.setattr(dops, "_call", call)
    monkeypatch.setattr(dops, "decode_attention", decode_attention)
    monkeypatch.setattr(sops, "ssd_intra", ssd_intra)
    return cs


@pytest.mark.parametrize("planted", [False, True])
def test_chip_smoke_bf16_steps_rehearsal(monkeypatch, planted):
    """``chip_smoke.run_bf16_steps`` and ``run_bf16_families`` on tiny
    configs on the CPU (``_rehearse``), so that the phase's launch gates,
    the bf16 rule and the kernel checks run as they do on the card.
    ``planted``: the bf16 decode output of one layer zeroed on every step
    (a fault of the bf16 kernel route alone), which the bf16 rule must
    refuse."""
    cs = _rehearse(monkeypatch, "decode" if planted else None)
    cfg = get_tiny("llama3-8b")
    params = TM.init_params(cfg, torch.Generator().manual_seed(0))
    card = "rehearsal"
    with torch.no_grad():
        p16 = cs.bf16_copy(params)
    if planted:
        with pytest.raises(RuntimeError, match="beyond the bf16 rule"):
            cs.run_bf16_steps(cfg, params, p16, "cpu", card)
        return
    out = cs.run_bf16_steps(cfg, params, p16, "cpu", card)
    n = cfg.num_layers
    assert out["launches"] == {
        "chunk_attention": {"bfloat16": 2 * n},
        "decode_attention": {"bfloat16": cs.SERVE_DECODE * n},
        "ssd_intra": {}}
    assert out["mesh_launches"]["decode_attention"] == {
        "bfloat16": 4 * cs.SERVE_DECODE * n}
    for k in ("kernel_vs_fp32", "kernel_vs_dense", "sharded_vs_unsharded"):
        assert out[k]["worst_rms_ratio"] <= 1.0, k
    for name in ("chunk_attention", "decode_attention"):
        assert out["kernels"][name]["err"] <= cs.TOL["bfloat16"]
    fams = cs.run_bf16_families("cpu", card)
    rg = fams["recurrentgemma-9b"]
    assert rg["launches"]["chunk_attention"] == {"bfloat16": 2}
    assert "decode_attention_b1" in rg["kernels"]
    m2 = fams["mamba2-370m"]
    assert m2["launches"] == {
        "chunk_attention": {}, "decode_attention": {},
        "ssd_intra": {"float32": 4}}
    # the plain routes ran the SSD on its plain version (here the same
    # function as the kernel's stand-in; on the card two computations)
    assert m2["plain_ssd"]
    assert m2["kernels"]["ssd_intra"]["worst_ratio"] <= 1.0
    t = fams["train"]
    assert t["bf16"]["param_dtype"] == "torch.bfloat16"
    assert t["loss_gaps"][0] <= cs.BF16_GAP_FACTOR * t["nll_gap"]
    u = t["first_update"]
    assert u["beyond_ulp_of_adamw"] == 0 and u["moved_share"] > 0
    assert u["beyond_ulp_of_fp32_share"] <= \
        cs.BF16_GAP_FACTOR * t["grad_sign_share"]


@pytest.mark.parametrize("planted", ["update", "ssd"])
def test_chip_smoke_bf16_phase_refuses_fault(monkeypatch, planted):
    """Phase 20's gates on two faults that its launch counts and falling
    losses alone would let through. "update": the bf16 params rounded
    toward zero after AdamW's fp32 update instead of to nearest (a broken
    rounding back to bf16, each param within one ulp of its right value),
    which the first-update check of ``bf16_train`` must refuse. "ssd":
    the SSD kernel's output moved by 1e-3 of its scale, which mamba2's
    gates (its plain routes on the plain SSD, its recorded SSD calls
    against ``ssd_intra_ref``) must refuse."""
    from repro_torch.training import optimizer as OPTM
    cs = _rehearse(monkeypatch, planted)
    if planted == "update":
        leaf = OPTM.adamw_leaf

        def truncated(cfg, g, m, v, p, *rest):
            if p.dtype != torch.bfloat16:
                return leaf(cfg, g, m, v, p, *rest)
            p32 = p.float()
            leaf(cfg, g, m, v, p32, *rest)
            # the low 16 bits dropped
            p.copy_((p32.view(torch.int32) & -65536).view(torch.float32))
        monkeypatch.setattr(OPTM, "adamw_leaf", truncated)
        with pytest.raises(RuntimeError, match="first update"):
            cs.bf16_train("cpu", "rehearsal")
        return
    monkeypatch.setattr(cs, "BF16_FAMILIES", ("mamba2-370m",))
    with pytest.raises(RuntimeError, match="beyond the bf16 rule|allclose"):
        cs.run_bf16_families("cpu", "rehearsal")


# ---------------------------------------------------------------------------
# the step roots, bf16, against the reference's
# ---------------------------------------------------------------------------
def test_init_cache_bf16_layout():
    """``init_cache`` at a bf16 config's dtype: bf16 K/V, media K/V and
    conv windows, the recurrent states ``h`` and ``s`` fp32, positions
    int32, as the reference's ``init_cache(cfg, B, S, dtype=bf16)``."""
    want = {"k": torch.bfloat16, "v": torch.bfloat16, "mk": torch.bfloat16,
            "mv": torch.bfloat16, "conv": torch.bfloat16,
            "h": torch.float32, "s": torch.float32, "pos": torch.int32}
    seen = set()
    for arch in ARCHS:
        cfg = _cfg(arch)
        for k, v in _flat(TM.init_cache(cfg, B, S, device=CPU)).items():
            name = k.rsplit("/", 1)[-1]
            assert v.dtype == want[name], (arch, k, v.dtype)
            seen.add(name)
    assert seen == set(want)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", DENSE)
def test_step_roots_bf16_match_reference(ref, arch, impl):
    """Prefill, 2 decode steps and the Cache-Craft step in bf16 over bf16
    caches on ``impl``, against the reference's jitted steps on the same
    route within the bf16 rule (the reference's fp32 steps on ``auto`` as
    the yardstick); cache dtypes equal, positions equal, the ring slots
    of ``local`` layers at position % window."""
    got, tag = port_steps(ref, arch, impl)
    for k, dt in got["dtypes"].items():
        assert dt == ref.get_meta(f"{tag}|prefill|dtype|{k}"), k
    hold_steps(f"{arch} {impl}", got, ref.step(tag),
               ref.step(f"{arch}|{impl}|yard"), _controls(ref, arch, impl))
    _ring_slots(get_tiny(arch), got[f"decode{DECODE - 1}"][1])


# ---------------------------------------------------------------------------
# the train step, bf16 params, fp32 moments and accumulation
# ---------------------------------------------------------------------------
def _ulp(b):
    """One bf16 ulp at |b| (the smallest normal's at 0)."""
    a = np.maximum(np.abs(b.astype(np.float32)), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(a)) - 7).astype(np.float32)


def hold_train(tag, got, ref, prefix, yard):
    """A bf16 train run against the reference's (``prefix``) by the bf16
    rule, with ``yard`` the reference's fp32 run (its prefix)."""
    losses16 = [float(ref[f"{prefix}|loss{i}"]) for i in range(STEPS)]
    losses32 = [float(ref[f"{yard}|loss{i}"]) for i in range(STEPS)]
    gn16 = [float(ref[f"{prefix}|gnorm{i}"]) for i in range(STEPS)]
    gn32 = [float(ref[f"{yard}|gnorm{i}"]) for i in range(STEPS)]
    base = yard.rsplit("|", 1)[0]
    nll = np.abs(ref[f"{base}|bf16|nll"] - ref[f"{yard}|nll"]).mean()
    # the norm of the grads' bf16-vs-fp32 gap at the initial params
    gkeys = [k for k in ref.res_keys if k.startswith(f"{yard}|grad|")]
    gn_ref = float(np.sqrt(sum(float(np.sum(np.square(
        ref[k].astype(np.float64) - ref[k.replace("|fp32|", "|bf16|")])))
        for k in gkeys)))
    loss_gap = max(abs(a - b) for a, b in zip(got["losses"], losses16))
    gn_gap = max(abs(a - b) for a, b in zip(got["gnorms"], gn16))
    lines = [f"losses port {got['losses']} reference {losses16} (fp32 "
             f"{losses32}): gap {loss_gap:.2e}, the reference's per-token "
             f"NLL gap {nll:.2e}",
             f"grad norms port {got['gnorms']} reference {gn16} (fp32 "
             f"{gn32}): gap {gn_gap:.2e}, the norm of the reference's grad "
             f"gap {gn_ref:.2e}"]
    assert all(np.isfinite(got["losses"]))
    loss_ok = loss_gap <= GAP_FACTOR * nll
    gn_ok = gn_gap <= GAP_FACTOR * gn_ref
    arch = base.split("|")[0]
    if arch in DRIFT and not (loss_ok and gn_ok):
        # the controls' gaps to the unsharded bf16 run they perturb
        ctl = [tuple(max(abs(float(ref[f"{arch}|train|ctl{sd}|{q}{i}"]) -
                             float(ref[f"{arch}|train|bf16|{q}{i}"]))
                         for i in range(STEPS)) for q in ("loss", "gnorm"))
               for sd in SEEDS]
        lines.append(f"controls (loss, grad norm) {ctl}")
        loss_ok = loss_ok or loss_gap <= DRIFT_FACTOR * max(
            c[0] for c in ctl)
        gn_ok = gn_ok or gn_gap <= DRIFT_FACTOR * max(c[1] for c in ctl)
    assert loss_ok, lines
    assert gn_ok, lines
    # the params: one bf16 ulp, but for a share of elements
    n = off = off_ref = 0
    worst = worst_ref = 0.0
    for k, a in got["state"].items():
        if not k.startswith("params/"):
            continue
        b = ref[f"{prefix}|state|{k}"]
        c = ref[f"{yard}|state|{k}"].astype(ml_dtypes.bfloat16).astype(
            np.float32)
        u = _ulp(b)
        n += a.size
        off += int((np.abs(a - b) > u).sum())
        off_ref += int((np.abs(c - b) > u).sum())
        worst = max(worst, _gap(a, b))
        worst_ref = max(worst_ref, _gap(c, b))
    lines.append(f"params beyond one bf16 ulp of the reference's: "
                 f"{off / n:.4%} (its fp32 run's {off_ref / n:.4%}), "
                 f"largest gap {worst:.2e} (its fp32 run's {worst_ref:.2e})")
    assert off <= GAP_FACTOR * off_ref and worst <= GAP_FACTOR * worst_ref, \
        lines[-1]
    for mom in ("m", "v"):
        keys = [k for k in got["state"] if k.startswith(f"opt/{mom}/")]
        ok, g, r, gm, rm = held(
            np.concatenate([got["state"][k].ravel() for k in keys]),
            np.concatenate([ref[f"{prefix}|state|{k}"].ravel()
                            for k in keys]),
            np.concatenate([ref[f"{yard}|state|{k}"].ravel()
                            for k in keys]))
        lines.append(f"{mom} rms gap {g:.2e} (reference {r:.2e}), max "
                     f"{gm:.2e} ({rm:.2e})")
        assert ok, lines[-1]
    assert float(ref[f"{prefix}|state|step"]) == STEPS
    print(f"{tag}: " + "; ".join(lines))


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_step_bf16_matches_reference(ref, arch):
    """3 bf16 train steps (accum 2, fp32 moments and grad sums) from the
    same bf16 params against the reference's jitted step, by the bf16
    rule (the reference's fp32 step on the same bf16-rounded params as
    the yardstick); the params stay bf16, the moments fp32."""
    got = port_train(arch)
    assert all(str(v).endswith("bfloat16") for k, v in got["dtypes"].items()
               if k.startswith("params/"))
    assert all(str(v).endswith("float32") for k, v in got["dtypes"].items()
               if k.startswith("opt/m/") or k.startswith("opt/v/"))
    hold_train(arch, got, ref, f"{arch}|train|bf16", f"{arch}|train|fp32")


# ---------------------------------------------------------------------------
# the sharded steps, bf16, against the reference's GSPMD-jitted ones
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", MESHES, ids=_mesh_tag)
@pytest.mark.parametrize("arch", SHARDED)
def test_sharded_serving_bf16_matches_reference(ref, arch, shape):
    """The three steps on the (data, model) mesh in bf16, on ``auto`` and
    ``kernel`` (the wrappers' plain versions on CPU tensors), each fed the
    reference's sharded bf16 state before it, against the reference's
    steps jitted on its own layouts (GSPMD), by the bf16 rule (its fp32
    steps on the same inputs, unsharded, as the yardstick). The port's
    ``psum`` adds bf16 partial sums in bf16, in shard order, as the
    reference's all-reduce of the bf16 partial products does. Also
    against the port's unsharded steps on the same inputs."""
    tag = f"{arch}|{_mesh_tag(shape)}"
    for impl in IMPLS:
        got = dict(port_prefill(arch, impl, shape))
        states = ref.states(tag + "|bf16")
        rest = run_steps(_cfg(arch), _params(arch), arch, impl, shape,
                         states=states, only=STEP_WHATS[1:])
        got.update(rest)
        hold_steps(f"{arch} {list(shape)} {impl}", got,
                   ref.step(tag + "|bf16"), ref.step(tag + "|yard"),
                   _controls(ref, arch, impl))
        whole = dict(port_prefill(arch, impl))
        whole.update(run_steps(_cfg(arch), _params(arch), arch, impl,
                               states=states, only=STEP_WHATS[1:]))
        hold_steps(f"{arch} {list(shape)} {impl} vs unsharded", got,
                   {w: whole[w] for w in ref.step(tag + "|bf16")},
                   ref.step(tag + "|yard"), _controls(ref, arch, impl))


@pytest.mark.parametrize("shape", MESHES, ids=_mesh_tag)
@pytest.mark.parametrize("arch", SHARDED)
def test_sharded_train_bf16_matches_reference(ref, arch, shape):
    """3 bf16 train steps with ZeRO-1 ``grad_specs`` and the layers split
    over "model", against the reference's GSPMD-jitted step on its own
    layouts, by the bf16 rule (its unsharded fp32 step as the
    yardstick)."""
    tag = f"{arch}|{_mesh_tag(shape)}"
    hold_train(f"{arch} {list(shape)}", port_train(arch, shape), ref,
               f"{tag}|train|bf16", f"{arch}|train|fp32")


# ---------------------------------------------------------------------------
# MoE in bf16 (ROADMAP C13)
# ---------------------------------------------------------------------------
class RouteLog:
    """Wraps ``model._moe_route`` while it lives (``close`` ends it).
    Without ``replay`` it records, per step and call, the router probs and
    expert ids; with ``replay`` (another log's records) it hands each call
    the recorded ids, the gates from its own probs at those ids, and
    records its own probs and ids."""

    def __init__(self, replay=None):
        self.rec, self.replay, self.what = {}, replay, None
        route = self.route = TM._moe_route

        def wrapped(ctx, p, h):
            xg, probs, gates, ids = route(ctx, p, h)
            key = (self.what, sum(k[0] == self.what for k in self.rec))
            self.rec[key] = (probs.detach().clone(), ids.clone())
            if self.replay is not None:
                ids = self.replay[key][1]
                gates = probs.gather(-1, ids)
                gates = gates / gates.sum(-1, keepdim=True)
            return xg, probs, gates, ids
        TM._moe_route = wrapped

    def step(self, what):
        self.what = what

    def close(self):
        TM._moe_route = self.route


def route_flips(rec16, rec32, k):
    """Tokens whose top-k expert set differs between the bf16 run and the
    fp32 run's own choice under the same upstream routes, over every
    call, and for each its fp32 margin (the k-th over the (k+1)-th
    prob); the largest bf16-vs-fp32 prob gap of the tokens that agree."""
    flips, agree_gap, n = [], 0.0, 0
    for key, (p16, i16) in rec16.items():
        p32, i32 = rec32[key]
        s16 = i16.sort(-1).values.reshape(-1, k)
        s32 = i32.sort(-1).values.reshape(-1, k)
        diff = (s16 != s32).any(-1)
        d = (p16.float() - p32).abs().reshape(-1, p32.shape[-1]).amax(-1)
        n += diff.numel()
        if (~diff).any():
            agree_gap = max(agree_gap, float(d[~diff].max()))
        top = p32.reshape(-1, p32.shape[-1]).sort(-1, descending=True).values
        margin = top[:, k - 1] - top[:, k]
        flips += [(key, float(m)) for m in margin[diff]]
    return flips, agree_gap, n


def _dense_gaps(ref):
    """The largest reference bf16-vs-fp32 gap (rms, max) of each step's
    logits and K / V over the dense-FFN families at these tiny widths
    and both routes."""
    out = collections.defaultdict(lambda: [0.0, 0.0])
    for arch in DENSE:
        for impl in IMPLS:
            r16 = ref.step(f"{arch}|{impl}|bf16")
            r32 = ref.step(f"{arch}|{impl}|yard")
            for what, (lg, cache) in r16.items():
                vals = [("logits", lg, r32[what][0])] + [
                    (k.rsplit("/", 1)[-1], v, r32[what][1][k])
                    for k, v in cache.items() if k.rsplit("/", 1)[-1] in
                    ("k", "v")]
                for name, a, b in vals:
                    o = out[(what, name)]
                    o[0] = max(o[0], _rms(a, b))
                    o[1] = max(o[1], _gap(a, b))
    return out


@pytest.mark.parametrize("arch", MOE)
def test_moe_bf16_c13(ref, arch):
    """C13: the reference's bf16 MoE fails on XLA:CPU (its error
    asserted). The port's fp32 steps fed the reference's fp32 states meet
    the parity standard against them. The port's bf16 steps (its own
    chain, ``auto`` and ``kernel``) are held against its fp32 steps on
    the same inputs (the bf16 states upcast) replaying the bf16 run's
    expert ids: within GAP_FACTOR x the largest reference bf16-vs-fp32
    gap of the dense-FFN families (rms, and the largest plus one bf16
    ulp); every route flip at a near tie."""
    err = ref.get_meta(f"{arch}|bf16|error")
    assert err is not None and C13_ERROR in err, err
    cfg16, cfg32 = _cfg(arch), _cfg(arch, bf16=False)
    got = run_steps(cfg32, _params(arch, bf16=False), arch, "auto",
                    states=ref.states(f"{arch}|auto|fp32"))
    for what, (lg, cache) in ref.step(f"{arch}|auto|fp32").items():
        np.testing.assert_allclose(got[what][0], lg, **PARITY)
        for k, v in cache.items():
            np.testing.assert_allclose(got[what][1][k], v, **PARITY,
                                       err_msg=f"{what} {k}")
    dense = _dense_gaps(ref)
    lines = []
    for impl in IMPLS:
        log16 = RouteLog()
        try:
            run16 = run_steps(cfg16, _params(arch), arch, impl,
                              on_step=log16.step)
        finally:
            log16.close()
        states = {w: c for w, c in run16["states"].items() if w != "prefill"}
        log32 = RouteLog(replay=log16.rec)
        try:
            run32 = run_steps(cfg32, _params(arch, bf16=False), arch, impl,
                              states=states, on_step=log32.step)
        finally:
            log32.close()
        flips, agree_gap, n = route_flips(
            {k: v for k, v in log16.rec.items() if k[0] != "full"},
            log32.rec, cfg16.experts_per_token)
        lines.append(f"{impl}: {len(flips)} of {n} routed tokens flip "
                     f"(fp32 margins {[round(m, 5) for _, m in flips]}), "
                     f"the router probs' bf16-vs-fp32 gap where they agree "
                     f"{agree_gap:.2e}")
        assert all(m <= 2 * agree_gap for _, m in flips), lines[-1]
        for what in [w for w in STEP_WHATS if w in run32]:
            lg16, c16 = run16[what]
            lg32, c32 = run32[what]
            vals = [("logits", lg16, lg32)] + [
                (k.rsplit("/", 1)[-1], v, c32[k]) for k, v in c16.items()
                if k.rsplit("/", 1)[-1] in ("k", "v")]
            for name, a, b in vals:
                r, rm = dense[(what, name)]
                g, gm = _rms(a, b), _gap(a, b)
                lines.append(f"{impl} {what} {name}: rms {g:.2e} (dense "
                             f"families' {r:.2e}), max {gm:.2e} ({rm:.2e})")
                assert g <= GAP_FACTOR * r and \
                    gm <= GAP_FACTOR * rm + _top_ulp(a), lines[-1]
            for k, v in c16.items():
                if not np.issubdtype(v.dtype, np.floating):
                    assert np.array_equal(v, c32[k]), (what, k)
    print(f"{arch} bf16 (C13): " + "; ".join(lines))
