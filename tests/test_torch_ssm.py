"""The port's SSM slice against the JAX package's: the selective scan and
its gradients, the Mamba blocks and decode steps, the decode cache, and
falcon-mamba-7b's smoke config end to end (loss, every gradient, one
AdamW step, greedy serving streams).

Inputs come from ``np.random.default_rng``; weights from the JAX
package's ``init_params`` through the bridge.  Where the JAX side reaches
its Pallas selective-scan kernel it runs in interpret mode (T <= 256,
di <= 256); the port runs the plain versions behind its
``SelectiveScan`` op on CPU tensors.

Tolerances (fp32 unless stated): scan outputs and gradients atol = rtol
= 2e-5 (sums of up to 256 steps and 16 states, in other orders);
losses relative 1e-5 and every gradient's relative L2 error 1e-4, as in
``test_torch_train.py``; decode logits rtol 1e-4 with equal greedy
tokens.  In bf16 the outputs that are rounded to bf16 (y, du, ddt, dB,
dC) may differ by one bf16 rounding of their fp32 values: atol = rtol =
2^-7, relative to the largest entry for atol.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.registry import cache_specs as jax_cache_specs
from repro.kernels.ref import selective_scan_ref
from repro.kernels.selective_scan import selective_scan as jax_selective_scan
from repro.models import ssm as jssm
from repro.models.model import init_params as jax_init_params
from repro.serving.serve_step import init_cache as jax_init_cache
from repro.serving.serve_step import make_serve_step as jax_make_serve_step
from repro.training import optimizer as jopt
from repro.training.train_step import make_loss_fn as jax_make_loss_fn
from repro.training.train_step import make_train_step as jax_make_train_step
from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.configs import cache_specs, get_config
from repro_torch.kernels.ops import selective_scan_op
from repro_torch.kernels.selective_scan import (
    SelectiveScan,
    selective_scan_bwd_plain,
    selective_scan_plain,
    ssm_bwd,
    ssm_fwd,
)
from repro_torch.models import ssm as tssm
from repro_torch.models.model import init_params
from repro_torch.serving.serve_step import init_cache, make_serve_step
from repro_torch.training import optimizer as topt
from repro_torch.training.train_step import batch_to_device, make_loss_fn, make_train_step

FP32_TOL = dict(atol=2e-5, rtol=2e-5)
BF16_REL = 2.0**-7
LOSS_RTOL = 1e-5
GRAD_REL_L2 = 1e-4


def _segments(rng, T, lo, hi, fill):
    """seg [T]: segments of lo..hi steps back to back, a seg-0 tail after
    ``fill`` of the stream, and one seg-0 gap inside."""
    seg = np.zeros(T, np.int32)
    off, sid = 0, 1
    while off < int(T * fill):
        n = min(int(rng.integers(lo, hi + 1)), int(T * fill) - off)
        seg[off:off + n] = sid
        off, sid = off + n + (2 if sid == 2 else 0), sid + 1
    return seg[:T]


def _scan_inputs(rng, T, di, N, dtype, streams=None):
    lead = () if streams is None else (streams,)
    u = rng.normal(size=lead + (T, di)).astype(np.float32)
    dt = rng.uniform(0.05, 1.0, size=lead + (T, di)).astype(np.float32)
    A = -rng.uniform(0.5, 4.0, size=(di, N)).astype(np.float32)
    B = rng.normal(size=lead + (T, N)).astype(np.float32)
    C = rng.normal(size=lead + (T, N)).astype(np.float32)
    D = rng.normal(size=(di,)).astype(np.float32)
    seg = np.stack([_segments(rng, T, 8, T // 3, 0.85) for _ in range(streams or 1)])
    seg = seg if streams else seg[0]
    if dtype == "bfloat16":  # values representable in bf16 on both sides
        u, dt, B, C = (np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
                       for a in (u, dt, B, C))
    return u, dt, A, B, C, D, seg


def _tensor(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t.to(getattr(torch, dtype)) if dtype else t


def _np(t):
    return t.detach().float().numpy()


def _assert_close(got, want, dtype, name):
    if dtype == "bfloat16":
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=BF16_REL, atol=BF16_REL * scale,
                                   err_msg=name)
    else:
        np.testing.assert_allclose(got, want, **FP32_TOL, err_msg=name)


# (T, di, N, dtype, block_d, chunk): segment resets and padding rows in
# every case; T = 200 is no multiple of 64 (chunk 50 through _fit_block).
SCAN_CASES = {
    "fp32_n16": (128, 64, 16, "float32", 32, 64),
    "bf16_n8": (128, 128, 8, "bfloat16", 64, 32),
    "fp32_ragged_t200_n4": (200, 96, 4, "float32", tssm._fit_block(96, 128),
                            tssm._fit_block(200, 64)),
}


def _jax_scan(case, inputs, cot):
    T, di, N, dtype, bd, ct = SCAN_CASES[case]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    u, dt, A, B, C, D, seg = inputs

    def fn(u_, dt_, A_, B_, C_, D_):
        return jax_selective_scan(u_, dt_, A_, B_, C_, D_, jnp.asarray(seg), block_d=bd,
                                  chunk=ct, interpret=True, return_state=True)

    args = [jnp.asarray(u, jdt), jnp.asarray(dt, jdt), jnp.asarray(A), jnp.asarray(B, jdt),
            jnp.asarray(C, jdt), jnp.asarray(D)]
    (y, hf), vjp = jax.vjp(fn, *args)
    grads = vjp((jnp.asarray(cot[0], jdt), jnp.asarray(cot[1])))
    return np.asarray(y.astype(jnp.float32)), np.asarray(hf), [
        np.asarray(g.astype(jnp.float32)) for g in grads]


def _torch_scan(case, inputs, cot):
    T, di, N, dtype, bd, ct = SCAN_CASES[case]
    u, dt, A, B, C, D, seg = inputs
    args = [_tensor(u, dtype), _tensor(dt, dtype), _tensor(A), _tensor(B, dtype),
            _tensor(C, dtype), _tensor(D)]
    for a in args:
        a.requires_grad_(True)
    y, hf = selective_scan_op(*args, _tensor(seg), block_d=bd, chunk=ct, return_state=True)
    grads = torch.autograd.grad((y, hf), args, (_tensor(cot[0], dtype), _tensor(cot[1])))
    return _np(y), _np(hf), [_np(g) for g in grads]


def _case_data(case):
    T, di, N, dtype, _, _ = SCAN_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    inputs = _scan_inputs(rng, T, di, N, dtype)
    cot = (rng.normal(size=(T, di)).astype(np.float32),
           rng.normal(size=(di, N)).astype(np.float32))
    if dtype == "bfloat16":
        cot = (np.asarray(jnp.asarray(cot[0], jnp.bfloat16).astype(jnp.float32)), cot[1])
    return inputs, cot


@pytest.mark.parametrize("case", sorted(SCAN_CASES))
def test_selective_scan_forward_matches_jax_kernel_and_oracle(case):
    """y and h_final against the Pallas kernel (interpret mode), and y
    against ``selective_scan_ref``."""
    inputs, cot = _case_data(case)
    dtype = SCAN_CASES[case][3]
    jy, jhf, _ = _jax_scan(case, inputs, cot)
    ty, thf, _ = _torch_scan(case, inputs, cot)
    _assert_close(ty, jy, dtype, "y")
    np.testing.assert_allclose(thf, jhf, **FP32_TOL, err_msg="h_final")
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    u, dt, A, B, C, D, seg = inputs
    ref = selective_scan_ref(jnp.asarray(u, jdt), jnp.asarray(dt, jdt), jnp.asarray(A),
                             jnp.asarray(B, jdt), jnp.asarray(C, jdt), jnp.asarray(D),
                             jnp.asarray(seg))
    _assert_close(ty, np.asarray(ref.astype(jnp.float32)), dtype, "y vs oracle")


@pytest.mark.parametrize("case", sorted(SCAN_CASES))
def test_selective_scan_vjp_matches_jax(case):
    """du, ddt, dA, dB, dC, dD of (y, h_final) with both cotangents,
    against ``jax.vjp`` of the Pallas kernel's custom VJP."""
    inputs, cot = _case_data(case)
    dtype = SCAN_CASES[case][3]
    _, _, jgrads = _jax_scan(case, inputs, cot)
    _, _, tgrads = _torch_scan(case, inputs, cot)
    for name, tg, jg in zip(("du", "ddt", "dA", "dB", "dC", "dD"), tgrads, jgrads):
        if dtype == "bfloat16" or name in ("dA", "dD"):
            # fp32 sums over every step (dA, dD) and the bf16 outputs:
            # relative to the largest entry
            scale = float(np.abs(jg).max())
            rel = BF16_REL if dtype == "bfloat16" else FP32_TOL["rtol"]
            np.testing.assert_allclose(tg, jg, rtol=rel, atol=rel * scale, err_msg=name)
        else:
            np.testing.assert_allclose(tg, jg, **FP32_TOL, err_msg=name)


def test_batched_streams_equal_one_stream_at_a_time():
    """The port batches streams where the JAX package vmaps: a [3, T, di]
    call gives each stream's own [T, di] result, gradients included (dA
    and dD summed over the streams)."""
    rng = np.random.default_rng(5)
    u, dt, A, B, C, D, seg = _scan_inputs(rng, 96, 40, 8, "float32", streams=3)
    dy = rng.normal(size=u.shape).astype(np.float32)
    args = [_tensor(a) for a in (u, dt, A, B, C, D)]
    y, hf = SelectiveScan.apply(*args, _tensor(seg))
    grads = selective_scan_bwd_plain(*args, _tensor(seg), _tensor(dy), torch.zeros_like(hf))
    dA_sum, dD_sum = torch.zeros_like(args[2]), torch.zeros_like(args[5])
    for s in range(3):
        one = [_tensor(a[s]) for a in (u, dt)] + [args[2]] + [
            _tensor(a[s]) for a in (B, C)] + [args[5]]
        ys, hfs = selective_scan_plain(*one, _tensor(seg[s]))
        torch.testing.assert_close(y[s], ys, rtol=0, atol=0)
        torch.testing.assert_close(hf[s], hfs, rtol=0, atol=0)
        gs = selective_scan_bwd_plain(*one, _tensor(seg[s]), _tensor(dy[s]),
                                      torch.zeros_like(hfs))
        for name, i in (("du", 0), ("ddt", 1), ("dB", 3), ("dC", 4)):
            torch.testing.assert_close(grads[i][s], gs[i], rtol=0, atol=0, msg=name)
        dA_sum += gs[2]
        dD_sum += gs[5]
    # the streams' sums taken in another order
    torch.testing.assert_close(grads[2], dA_sum, **FP32_TOL)
    torch.testing.assert_close(grads[5], dD_sum, **FP32_TOL)


@pytest.mark.parametrize("T,di,block_d,chunk,match", [
    (96, 48, 32, 64, "di=48 % 32"), (100, 64, 64, 64, "T=100 % 64")])
def test_refuses_what_jax_refuses(T, di, block_d, chunk, match):
    rng = np.random.default_rng(0)
    u, dt, A, B, C, D, seg = _scan_inputs(rng, T, di, 4, "float32")
    with pytest.raises(ValueError, match=match):
        jax_selective_scan(*(jnp.asarray(a) for a in (u, dt, A, B, C, D, seg)),
                           block_d=block_d, chunk=chunk, interpret=True)
    with pytest.raises(ValueError, match=match):
        selective_scan_op(*(_tensor(a) for a in (u, dt, A, B, C, D, seg)),
                          block_d=block_d, chunk=chunk)


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers take CUDA tensors only; CPU tensors are refused
    before any build or launch."""
    rng = np.random.default_rng(0)
    u, dt, A, B, C, D, seg = (_tensor(a) for a in _scan_inputs(rng, 64, 32, 4, "float32",
                                                               streams=1))
    with pytest.raises(ValueError, match="CUDA"):
        ssm_fwd(u, dt, A, B, C, D, seg)
    ckpt = torch.zeros(1, 1, 32, 4)
    with pytest.raises(ValueError, match="CUDA"):
        ssm_bwd(u, dt, A, B, C, D, seg, ckpt, u, torch.zeros(1, 32, 4))


# ----------------------------------------------------------------------
# Blocks.
# ----------------------------------------------------------------------
def test_causal_conv1d_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 50, 12)).astype(np.float32)
    w = rng.normal(size=(4, 12)).astype(np.float32)
    seg = np.stack([_segments(rng, 50, 3, 12, 0.8) for _ in range(2)])
    want = jssm.causal_conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(seg))
    got = tssm.causal_conv1d(_tensor(x), _tensor(w), _tensor(seg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("backend,T,chunk,h0", [
    ("scan", 96, 32, False), ("scan", 100, 32, True), ("pallas", 96, 32, False)])
def test_mamba1_scan_matches_jax(backend, T, chunk, h0):
    """Both backends against the JAX package's, one stream.  T = 100 with
    chunk 32 pads the scan backend's last chunk as the JAX package does
    (its final state is that of the padded stream)."""
    rng = np.random.default_rng(T + chunk)
    u, dt, A, B, C, D, seg = _scan_inputs(rng, T, 48, 8, "float32")
    h = rng.normal(size=(48, 8)).astype(np.float32) if h0 else None
    kw = dict(chunk=chunk, backend=backend, block_d=16)
    jy, jhf = jssm.mamba1_scan(*(jnp.asarray(a) for a in (u, dt, A, B, C, D, seg)),
                               h0=None if h is None else jnp.asarray(h), **kw)
    ty, thf = tssm.mamba1_scan(*(_tensor(a) for a in (u, dt, A, B, C, D, seg)),
                               h0=None if h is None else _tensor(h), **kw)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **FP32_TOL)
    np.testing.assert_allclose(thf.numpy(), np.asarray(jhf), **FP32_TOL)
    if backend == "pallas":
        with pytest.raises(ValueError, match="h0"):
            tssm.mamba1_scan(*(_tensor(a) for a in (u, dt, A, B, C, D, seg)),
                             h0=torch.zeros(48, 8), **kw)


@pytest.mark.parametrize("backend", ["scan", "pallas"])
def test_mamba2_scan_matches_jax(backend):
    """Per-head scalar decay; the pallas backend broadcasts it onto the
    Mamba-1 op (interpret mode on the JAX side)."""
    rng = np.random.default_rng(7)
    T, H, P, N = 64, 4, 8, 16
    x = rng.normal(size=(T, H, P)).astype(np.float32)
    dt = rng.uniform(0.05, 1.0, size=(T, H)).astype(np.float32)
    a_log = rng.normal(size=(H,)).astype(np.float32)
    B, C = (rng.normal(size=(T, N)).astype(np.float32) for _ in range(2))
    D = rng.normal(size=(H,)).astype(np.float32)
    seg = _segments(rng, T, 6, 30, 0.9)
    kw = dict(chunk=32, backend=backend, block_d=16)
    jy, jhf = jssm.mamba2_scan(*(jnp.asarray(a) for a in (x, dt, a_log, B, C, D, seg)), **kw)
    ty, thf = tssm.mamba2_scan(*(_tensor(a) for a in (x, dt, a_log, B, C, D, seg)), **kw)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **FP32_TOL)
    np.testing.assert_allclose(thf.numpy(), np.asarray(jhf), **FP32_TOL)


def _smoke(arch, **kw):
    jcfg = dataclasses.replace(jax_get_config(arch).smoke(), dtype="float32", **kw)
    tcfg = dataclasses.replace(get_config("falcon_mamba_7b").smoke(), dtype="float32",
                               **kw) if arch == "falcon_mamba_7b" else None
    return jcfg, tcfg


def _layer0(jparams):
    return {k: v[0] for k, v in jparams["layers"].items()}


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("variant,backend", [("mamba1", "scan"), ("mamba1", "pallas"),
                                             ("mamba2", "scan"), ("mamba2", "pallas")])
def test_blocks_match_jax(variant, backend):
    """mamba1_block (falcon-mamba smoke) and mamba2_block (zamba2 smoke)
    on 2 streams: outputs and the gradients of every block parameter and
    of x, against ``jax.vjp``."""
    arch = "falcon_mamba_7b" if variant == "mamba1" else "zamba2_2_7b"
    jcfg, _ = _smoke(arch)
    jp = _layer0(jax_init_params(jcfg, jax.random.PRNGKey(3)))
    jp = {k: v for k, v in jp.items() if k != "norm"}
    rng = np.random.default_rng(11)
    T = 64
    x = rng.normal(size=(2, T, jcfg.d_model)).astype(np.float32)
    seg = np.stack([_segments(rng, T, 6, 30, 0.9) for _ in range(2)])
    dy = rng.normal(size=x.shape).astype(np.float32)
    kw = dict(ssm_state=jcfg.ssm_state, chunk=32, backend=backend, block_d=64)
    if variant == "mamba2":
        kw["headdim"] = jcfg.ssm_headdim
    jblock, tblock = ((jssm.mamba1_block, tssm.mamba1_block) if variant == "mamba1"
                      else (jssm.mamba2_block, tssm.mamba2_block))
    jout, vjp = jax.vjp(lambda p, x_: jblock(p, x_, jnp.asarray(seg), **kw), jp,
                        jnp.asarray(x))
    jgp, jgx = vjp(jnp.asarray(dy))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    for t in tp.values():
        t.requires_grad_(True)
    tx = _tensor(x).requires_grad_()
    out = tblock(tp, tx, _tensor(seg), **kw)
    grads = torch.autograd.grad(out, [tx, *tp.values()], _tensor(dy))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=1e-4, atol=1e-5)
    assert _rel_l2(grads[0].numpy(), np.asarray(jgx)) <= GRAD_REL_L2
    for name, g in zip(tp, grads[1:]):
        assert _rel_l2(g.numpy(), np.asarray(jgp[name])) <= GRAD_REL_L2, name


@pytest.mark.parametrize("variant", ["mamba1", "mamba2"])
def test_decode_steps_match_jax(variant):
    """Five O(1) decode steps from a zero state: outputs, conv windows and
    states against the JAX package's."""
    arch = "falcon_mamba_7b" if variant == "mamba1" else "zamba2_2_7b"
    jcfg, _ = _smoke(arch)
    jp = _layer0(jax_init_params(jcfg, jax.random.PRNGKey(4)))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    di, N, K, Bs = jcfg.d_inner, jcfg.ssm_state, jcfg.ssm_conv, 3
    if variant == "mamba1":
        h_shape, kw = (Bs, di, N), dict(ssm_state=N)
        jstep, tstep = jssm.mamba1_decode_step, tssm.mamba1_decode_step
    else:
        H = di // jcfg.ssm_headdim
        h_shape = (Bs, H, jcfg.ssm_headdim, N)
        kw = dict(ssm_state=N, headdim=jcfg.ssm_headdim)
        jstep, tstep = jssm.mamba2_decode_step, tssm.mamba2_decode_step
    jst = {"conv": jnp.zeros((Bs, K - 1, di), jnp.bfloat16), "h": jnp.zeros(h_shape)}
    tst = {"conv": torch.zeros((Bs, K - 1, di), dtype=torch.bfloat16),
           "h": torch.zeros(h_shape)}
    rng = np.random.default_rng(6)
    for _ in range(5):
        x = rng.normal(size=(Bs, jcfg.d_model)).astype(np.float32)
        jo, jst = jstep(jp, jnp.asarray(x), jst, **kw)
        to, tst = tstep(tp, _tensor(x), tst, **kw)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-4, atol=1e-5)
        assert tst["conv"].dtype == torch.float32 and jst["conv"].dtype == jnp.float32
        for name in ("conv", "h"):
            np.testing.assert_allclose(tst[name].numpy(), np.asarray(jst[name]), rtol=1e-4,
                                       atol=1e-5, err_msg=name)


@pytest.mark.parametrize("arch,dtype", [("falcon_mamba_7b", "bfloat16"),
                                        ("falcon_mamba_7b", "float32"),
                                        ("mllm_10b", "bfloat16"),
                                        ("zamba2_2_7b", "bfloat16"),
                                        ("zamba2_2_7b", "float32")])
def test_cache_specs_and_init_cache_match_jax(arch, dtype):
    """Shapes and dtypes of the dense decode cache (ssm state; KV cache;
    the hybrid's Mamba-2 state and shared-block KV caches), at the full
    config and its smoke variant."""
    for full in (True, False):
        tcfg = get_config(arch) if full else get_config(arch).smoke()
        jcfg = jax_get_config(arch) if full else jax_get_config(arch).smoke()
        tcfg, jcfg = (dataclasses.replace(c, dtype=dtype) for c in (tcfg, jcfg))
        specs, ref = cache_specs(tcfg, 3, 40), jax_cache_specs(jcfg, 3, 40)
        assert specs.keys() == ref.keys()
        for name, (shape, dt) in specs.items():
            assert shape == ref[name].shape, name
            assert str(dt).removeprefix("torch.") == np.dtype(ref[name].dtype).name, name
        if not full:
            cache, jcache = init_cache(tcfg, 3, 40, device="cpu"), jax_init_cache(jcfg, 3, 40)
            for name, t in cache.items():
                assert tuple(t.shape) == jcache[name].shape and not t.any(), name
    with pytest.raises(ValueError, match="audio"):
        cache_specs(dataclasses.replace(get_config("falcon_mamba_7b"), family="audio"), 1, 8)


# ----------------------------------------------------------------------
# The slice: falcon-mamba-7b's smoke config, 2 layers, fp32.
# ----------------------------------------------------------------------
def _packed_batch(rng, S, T, vocab):
    """A text-only post-balanced batch as the orchestrator lays it out:
    examples back to back per stream, positions restarting, next-token
    labels inside each example (-1 at its last token and on padding)."""
    seg = np.stack([_segments(rng, T, 10, 70, 0.9) for _ in range(S)])
    tokens = np.where(seg > 0, rng.integers(1, vocab, size=(S, T)), 0).astype(np.int32)
    pos = np.zeros((S, T), np.int32)
    for s in range(S):
        for t in range(1, T):
            pos[s, t] = pos[s, t - 1] + 1 if seg[s, t] == seg[s, t - 1] > 0 else 0
    nxt_same = np.concatenate([seg[:, 1:] == seg[:, :-1], np.zeros((S, 1), bool)], 1)
    labels = np.where((seg > 0) & nxt_same, np.roll(tokens, -1, axis=1), -1).astype(np.int32)
    return {"tokens": tokens, "labels": labels, "seg": seg, "pos": pos}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: v})
    return out


@pytest.fixture(scope="module")
def falcon_smoke():
    jcfg, tcfg = _smoke("falcon_mamba_7b")
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jparams = jax.jit(jax_init_params, static_argnums=0)(jcfg, jax.random.PRNGKey(0))
    batch = _packed_batch(np.random.default_rng(8), 2, 192, jcfg.vocab_size)
    return jcfg, tcfg, jparams, batch


def test_falcon_smoke_loss_and_gradients_match_jax(falcon_smoke):
    jcfg, tcfg, jparams, batch = falcon_smoke
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(jax_make_loss_fn(jcfg), has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    jgrads = _flat(jax.tree.map(np.asarray, jgrads))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    leaves = topt.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, m = make_loss_fn(tcfg)(params, batch_to_device(batch, "cpu"))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    assert abs(float(loss.detach()) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    assert int(m["tokens"]) == int(jm["tokens"]) > 0 and float(m["aux_loss"]) == 0.0
    names = list(_flat(params))
    assert set(names) == set(jgrads)
    errs = {n: _rel_l2(g.numpy(), jgrads[n]) for n, g in zip(names, grads)}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_REL_L2, (worst, errs[worst])


def test_falcon_smoke_adamw_step_matches_jax(falcon_smoke):
    """One train step (loss, gradients, clipping, AdamW with decay of
    the stacked [L, di] dt_bias / D and [L, di, N] A_log): every updated
    parameter against the JAX package's step.  eps = 1e-3 keeps the first
    step's ratio g / (|g| + eps) smooth: at the default 1e-8 an entry whose
    gradient is itself ~1e-8 moves by up to lr under a rounding-level
    difference of that gradient."""
    jcfg, tcfg, jparams, batch = falcon_smoke
    opt = dict(lr=1e-3, eps=1e-3)
    jstep = jax.jit(jax_make_train_step(jcfg, jopt.AdamWConfig(**opt)))
    jp, _, jm = jstep(jparams, jopt.adamw_init(jparams),
                      {k: jnp.asarray(v) for k, v in batch.items()})
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    tp, tstate, tm = make_train_step(tcfg, topt.AdamWConfig(**opt))(
        params, topt.adamw_init(params), batch_to_device(batch, "cpu"))
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= LOSS_RTOL * abs(float(jm["loss"]))
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=GRAD_REL_L2)
    want = _flat(jax.tree.map(np.asarray, jp))
    for name, got in _flat(params_to_numpy(tp)).items():
        np.testing.assert_allclose(got, want[name], rtol=1e-6, atol=1e-6, err_msg=name)
    assert int(tstate["step"]) == 1


def test_optimizer_decays_stacked_ssm_leaves():
    """The JAX package decays every leaf with ndim >= 2, so the stacked
    dt_bias [L, di], D [L, di] and A_log [L, di, N] are decayed and the
    final norm (D,) is not; the port applies the same rule."""
    rng = np.random.default_rng(2)
    tree = {"layers": {"dt_bias": rng.normal(size=(2, 6)).astype(np.float32),
                       "D": rng.normal(size=(2, 6)).astype(np.float32),
                       "A_log": rng.normal(size=(2, 6, 4)).astype(np.float32)},
            "final_norm": rng.normal(size=(5,)).astype(np.float32)}
    zero = jax.tree.map(np.zeros_like, tree)
    cfg = dict(lr=0.1, weight_decay=0.5)
    jp, _, _ = jopt.adamw_update(jax.tree.map(jnp.asarray, tree), jax.tree.map(
        jnp.asarray, zero), jopt.adamw_init(tree), jopt.AdamWConfig(**cfg))
    tp = params_from_numpy(tree, device="cpu")
    tp, _, _ = topt.adamw_update(tp, params_from_numpy(zero, device="cpu"),
                                 topt.adamw_init(tp), topt.AdamWConfig(**cfg))
    got, want, orig = _flat(params_to_numpy(tp)), _flat(jax.tree.map(np.asarray, jp)), \
        _flat(tree)
    for name in got:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-6, err_msg=name)
        decayed = orig[name] * (1 - cfg["lr"] * cfg["weight_decay"])
        np.testing.assert_allclose(got[name], decayed if orig[name].ndim >= 2
                                   else orig[name], rtol=1e-6, err_msg=name)


def test_falcon_smoke_serve_streams_match_jax(falcon_smoke):
    """Greedy dense serve_step streams of 3 rows for 12 steps from
    ``init_cache``: the same tokens, logits within rtol 1e-4."""
    jcfg, tcfg, jparams, _ = falcon_smoke
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    jstep = jax.jit(jax_make_serve_step(jcfg))
    tstep = make_serve_step(tcfg)
    jcache, tcache = jax_init_cache(jcfg, 3, 16), init_cache(tcfg, 3, 16, device="cpu")
    tok = np.random.default_rng(9).integers(1, jcfg.vocab_size, size=(3, 1)).astype(np.int32)
    jtok, ttok = jnp.asarray(tok), torch.from_numpy(tok).long()
    for t in range(12):
        jtok, jlogits, jcache = jstep(jparams, jtok, jcache, jnp.int32(t))
        ttok, tlogits, tcache = tstep(params, ttok, tcache, t)
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    for name in ("conv", "h"):
        np.testing.assert_allclose(tcache[name].float().numpy(),
                                   np.asarray(jcache[name]).astype(np.float32), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def test_init_cache_defaults_to_cuda_and_refuses_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        init_cache(get_config("falcon_mamba_7b").smoke(), 2, 8)


def test_bridge_keeps_ssm_decay_and_skip_fp32():
    """``dtype=torch.bfloat16`` casts the falcon-mamba weights but keeps
    A_log and D in fp32, as the JAX package's bf16 model holds them."""
    jcfg = jax_get_config("falcon_mamba_7b").smoke()
    tree = jax.tree.map(np.asarray, jax_init_params(
        dataclasses.replace(jcfg, dtype="float32"), jax.random.PRNGKey(1)))
    params = params_from_numpy(tree, device="cpu", dtype=torch.bfloat16)
    layers = params["layers"]
    assert layers["A_log"].dtype == layers["D"].dtype == torch.float32
    assert all(t.dtype == torch.bfloat16 for k, t in layers.items() if k not in ("A_log", "D"))
    assert params["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(layers["A_log"].numpy(), tree["layers"]["A_log"])


def test_init_params_matches_jax_layout_and_constants():
    """Same keys, shapes and dtypes as the JAX package's bf16 falcon-mamba
    parameters (A_log and D fp32), with A_log = log(1..N), D = 1 and
    dt_bias = 0 as there."""
    jcfg = jax_get_config("falcon_mamba_7b").smoke()
    tree = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(0)))
    params = init_params(get_config("falcon_mamba_7b").smoke(), seed=0, device="cpu")
    flat_t, flat_j = _flat(params), _flat(tree)
    assert flat_t.keys() == flat_j.keys()
    for name, t in flat_t.items():
        assert tuple(t.shape) == flat_j[name].shape, name
        assert str(t.dtype).removeprefix("torch.") == flat_j[name].dtype.name, name
    for name in ("layers/D", "layers/dt_bias", "layers/norm", "final_norm"):
        np.testing.assert_array_equal(flat_t[name].float().numpy(),
                                      flat_j[name].astype(np.float32), err_msg=name)
    # log(1..N) by two libraries: within one fp32 ulp
    np.testing.assert_allclose(flat_t["layers/A_log"].numpy(), flat_j["layers/A_log"],
                               rtol=2.0**-23, atol=0)
