"""Head dims the attention kernels do not instantiate.

The CUDA kernels are built at D 64 and 128.  The flash backend's ``_flash``
zero-pads any other D up to the next of these (32 -> 64; 80, 100, 120 ->
128) in the copy it already makes, keeps the true D's score scale, and
slices the padded output columns off; D above 128 is refused.  The pad is
exact, so the padded route must give the plain version's out, lse and
dq/dk/dv at the true D (lse from the op on operands padded by the same
rule).  On the CPU the route runs through the plain versions at the
padded D, the same code that feeds the kernels on the card.  Tolerance:
1e-6 of the largest entry of each reference tensor (sums over the padded
columns add zeros, in another order).
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as tfa
from repro_torch.models import attention as tattn

HEAD_DIMS = (32, 80, 100, 120)
# (H, Hkv, causal, window)
LAYOUTS = {
    "mha_causal": (4, 4, True, None),
    "gqa_causal": (4, 2, True, None),
    "gqa_bidirectional": (6, 2, False, None),
    "gqa_window": (4, 2, True, 24),
}
REL = 1e-6


def _inputs(D, H, Hkv, seed):
    """q [B,T,H,D], k/v/do, and a packed seg/pos with a padded tail; T =
    90 is no multiple of 8, so ``_flash`` pads T as well."""
    rng = np.random.default_rng(seed)
    B, T = 2, 90
    seg = np.zeros((B, T), np.int32)
    pos = np.zeros((B, T), np.int32)
    for b in range(B):
        off, sid = 0, 1
        while off < 80:
            n = min(int(rng.integers(8, 40)), 80 - off)
            seg[b, off:off + n], pos[b, off:off + n] = sid, np.arange(n)
            off, sid = off + n, sid + 1
    arrays = [rng.normal(size=(B, T, h, D)).astype(np.float32) for h in (H, Hkv, Hkv, H)]
    return [torch.from_numpy(a) for a in arrays], torch.from_numpy(seg), torch.from_numpy(pos)


def _close(got, want, label):
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= REL * scale, (label, err, scale)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_padded_route_equals_plain_version_at_true_head_dim(D, layout):
    H, Hkv, causal, window = LAYOUTS[layout]
    (q, k, v, do), seg, pos = _inputs(D, H, Hkv, seed=D + H)
    q, k, v = (t.clone().requires_grad_() for t in (q, k, v))
    out = tattn.attention(q, k, v, q_seg=seg, kv_seg=seg, q_pos=pos, kv_pos=pos,
                          causal=causal, window=window, backend="flash")
    assert out.shape == q.shape
    dq, dk, dv = torch.autograd.grad(out, (q, k, v), do)

    def hf(t):
        return t.detach().transpose(1, 2).contiguous()

    padded, scale = tfa.pad_head_dim([hf(t) for t in (q, k, v)])
    assert padded[0].shape[-1] == tfa.padded_head_dim(D)
    assert scale == 1.0 / math.sqrt(D)
    _, lse = tfa.FlashAttention.apply(*padded, seg, seg, pos, pos, causal, window, scale)
    kw = dict(causal=causal, window=window)
    ref_out, ref_lse = tfa.flash_attention_plain(hf(q), hf(k), hf(v), seg, seg, pos, pos,
                                                 **kw)
    ref = tfa.flash_attention_bwd_plain(hf(q), hf(k), hf(v), hf(do), ref_out, ref_lse, seg,
                                        seg, pos, pos, **kw)
    _close(hf(out), ref_out, "out")
    _close(lse, ref_lse, "lse")
    for label, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        assert got.shape[-1] == D, label
        _close(hf(got), want, label)


@pytest.mark.parametrize("D", [32, 64, 80, 100, 120, 128])
def test_padded_head_dim_rule(D):
    assert tfa.padded_head_dim(D) == (64 if D <= 64 else 128)


@pytest.mark.parametrize("D", [136, 256])
def test_head_dims_above_128_are_refused(D):
    (q, k, v, _), seg, pos = _inputs(D, 2, 2, seed=0)
    with pytest.raises(ValueError, match="head_dim"):
        tattn.attention(q, k, v, q_seg=seg, kv_seg=seg, q_pos=pos, kv_pos=pos,
                        backend="flash")


def test_scale_reaches_both_plain_versions():
    """``scale`` replaces ``1 / sqrt(D)`` in the forward and the
    backward: the op at D 64 with the scale of D 80 equals the plain
    versions at that scale, and differs from the default."""
    (q, k, v, do), seg, pos = _inputs(64, 4, 2, seed=3)
    q, k, v, do = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))
    scale = 1.0 / math.sqrt(80)
    qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
    out, lse = tfa.FlashAttention.apply(qs, ks, vs, seg, seg, pos, pos, True, None, scale)
    grads = torch.autograd.grad(out, (qs, ks, vs), do)
    ref_out, ref_lse = tfa.flash_attention_plain(q, k, v, seg, seg, pos, pos, scale=scale)
    ref = tfa.flash_attention_bwd_plain(q, k, v, do, ref_out, ref_lse, seg, seg, pos, pos,
                                        scale=scale)
    torch.testing.assert_close(out, ref_out, rtol=0, atol=0)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=0)
    for got, want in zip(grads, ref):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    default, _ = tfa.flash_attention_plain(q, k, v, seg, seg, pos, pos)
    assert not torch.allclose(default, ref_out)
