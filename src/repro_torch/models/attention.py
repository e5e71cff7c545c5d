"""Attention for packed (post-balanced) batches (``repro.models.attention``
in PyTorch).

Segment id 0 is padding; positive ids are example ids; positions
restart at 0 per example.  :func:`attention` selects a ``backend``:

  * ``reference``  full [Tq, Tkv] score matrix;
  * ``chunked``    (the default) online softmax over KV blocks in eager
                   PyTorch, with a backward that recomputes each score
                   block from the saved row statistics instead of keeping
                   the [Tq, Tkv] probabilities (``_chunked`` and
                   ``_flash_bwd_blocks`` of the JAX package);
  * ``chunked_unrolled``  the same computation as ``chunked``: the JAX
                   package unrolls its KV scan only so that XLA's
                   ``cost_analysis`` counts every block, which eager
                   PyTorch has no need of;
  * ``flash``      the segment flash-attention kernels behind the
                   model-level ``[B, T, H, D]`` calling convention
                   (``kernels.ops.flash_attention_op``: the CUDA forward
                   and backward kernels on CUDA tensors, their plain
                   versions on CPU tensors), a head dim the kernels do not
                   instantiate zero-padded to one they do;
                   ``flash_interpret`` is an alias, the JAX package's name
                   for its CPU mode.

Every backend is differentiable in q, k and v.

Shapes: q [B,Tq,H,D]; k,v [B,Tkv,Hkv,D] with q head h reading KV head
``h // (H // Hkv)``; seg/pos [B,T*] int.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import NEG_INF, make_segment_mask, pad_head_dim
from repro_torch.kernels.ops import flash_attention_op
from repro_torch.utils import round_up

__all__ = ["ATTENTION_BACKENDS", "NEG_INF", "attention", "make_segment_mask"]

ATTENTION_BACKENDS = ("reference", "chunked", "chunked_unrolled", "flash",
                      "flash_interpret")
_INT32_MAX = 2**31 - 1


def _promote(a, b):
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def _gqa_scores(q, k):
    """q [B,Tq,H,D], k [B,Tkv,Hkv,D] -> scores [B,H,Tq,Tkv]."""
    B, Tq, H, D = q.shape
    Hkv = k.shape[2]
    q, k = _promote(q, k)
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.reshape(B, Tq, Hkv, H // Hkv, D), k)
    return s.reshape(B, H, Tq, k.shape[1])


def _gqa_out(p, v):
    """p [B,H,Tq,Tkv], v [B,Tkv,Hkv,D] -> [B,Tq,H,D]."""
    B, H, Tq, Tkv = p.shape
    Hkv = v.shape[2]
    p, v = _promote(p, v)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p.reshape(B, Hkv, H // Hkv, Tq, Tkv), v)
    return o.reshape(B, Tq, H, v.shape[-1])


def _reference(q, k, v, mask, scale):
    s = _gqa_scores(q, k).float() * scale
    s = torch.where(mask[:, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    # Fully-masked rows (padding queries) -> zero output.
    p = torch.where(mask[:, None].any(dim=-1, keepdim=True), p, torch.zeros_like(p))
    return _gqa_out(p.to(q.dtype), v)


def _pad_t(x, n, value=0):
    """Pad dim 1 (time) of x by n entries of ``value``."""
    return F.pad(x, (0, 0) * (x.dim() - 2) + (0, n), value=value)


def _blocks(q, k, v, q_seg, kv_seg, q_pos, kv_pos, causal, block_q, block_kv):
    """The JAX package's blocked views: T padded to the block sizes
    (padding has segment 0; causal pads key positions with int32 max),
    q-side tensors as [B, nq, bq, ...] and k-side as [B, nk, bkv, ...]."""
    B, Tq = q.shape[:2]
    Tkv = k.shape[1]
    bq, bkv = min(block_q, Tq), min(block_kv, Tkv)
    nq, nk = -(-Tq // bq), -(-Tkv // bkv)
    pq, pk = nq * bq - Tq, nk * bkv - Tkv

    def qside(x):
        x = _pad_t(x, pq)
        return x.reshape((B, nq, bq) + tuple(x.shape[2:]))

    def kside(x, value=0):
        x = _pad_t(x, pk, value)
        return x.reshape((B, nk, bkv) + tuple(x.shape[2:]))

    kp = kside(kv_pos, _INT32_MAX if causal else 0)
    return (qside(q), kside(k), kside(v), qside(q_seg), kside(kv_seg), qside(q_pos),
            kp, (Tq, Tkv, nq, nk))


def _block_scores(qb, kj, qs, ks, qp, kp, *, causal, window, scale):
    """Masked fp32 scores of every Q block against KV block j:
    qb [B,nq,bq,H,D], kj [B,bkv,Hkv,D] -> [B,nq,H,bq,bkv]."""
    B, nq, bq, H, D = qb.shape
    Hkv = kj.shape[2]
    qg, kj = _promote(qb.reshape(B, nq, bq, Hkv, H // Hkv, D), kj)
    s = torch.einsum("bnqhgd,bkhd->bnhgqk", qg, kj).reshape(B, nq, H, bq, -1)
    s = s.float() * scale
    mask = make_segment_mask(qs, ks[:, None], qp, kp[:, None], causal=causal,
                             window=window)
    return torch.where(mask[:, :, None], s, torch.full_like(s, NEG_INF))


def _block_out(p, vj):
    """p [B,nq,H,bq,bkv], vj [B,bkv,Hkv,D] -> [B,nq,bq,H,D]."""
    B, nq, H, bq, bkv = p.shape
    Hkv = vj.shape[2]
    p, vj = _promote(p.reshape(B, nq, Hkv, H // Hkv, bq, bkv), vj)
    return torch.einsum("bnhgqk,bkhd->bnqhgd", p, vj).reshape(B, nq, bq, H, -1)


class _Chunked(torch.autograd.Function):
    """Online-softmax attention over KV blocks; the backward recomputes
    each score block from (q, k) and the saved row statistics (m, l)."""

    @staticmethod
    def forward(ctx, q, k, v, q_seg, kv_seg, q_pos, kv_pos, causal, window, scale,
                block_q, block_kv):
        qb, kb, vb, qs, ks, qp, kp, (Tq, _, nq, nk) = _blocks(
            q, k, v, q_seg, kv_seg, q_pos, kv_pos, causal, block_q, block_kv)
        B, _, bq, H, D = qb.shape
        m = torch.full((B, nq, H, bq), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, nq, bq, H, D), dtype=torch.float32, device=q.device)
        for j in range(nk):
            s = _block_scores(qb, kb[:, j], qs, ks[:, j], qp, kp[:, j], causal=causal,
                              window=window, scale=scale)
            m_new = torch.maximum(m, s.amax(dim=-1))
            # Masked entries contribute exactly zero (fully-masked rows would
            # otherwise see exp(NEG_INF - NEG_INF) = 1).
            p = torch.exp(s - m_new[..., None]) * (s > NEG_INF / 2)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = _block_out(p.to(v.dtype), vb[:, j])
            acc = acc * corr.transpose(2, 3)[..., None] + pv.float()
            m = m_new
        l_safe = torch.where(l == 0, torch.ones_like(l), l)
        out = acc / l_safe.transpose(2, 3)[..., None]
        out = out.reshape(B, nq * bq, H, D)[:, :Tq].to(q.dtype)
        ctx.save_for_backward(q, k, v, q_seg, kv_seg, q_pos, kv_pos, out, m, l_safe)
        ctx.args = (causal, window, scale, block_q, block_kv)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, q_seg, kv_seg, q_pos, kv_pos, out, m, l = ctx.saved_tensors
        causal, window, scale, block_q, block_kv = ctx.args
        qb, kb, vb, qs, ks, qp, kp, (Tq, Tkv, nq, nk) = _blocks(
            q, k, v, q_seg, kv_seg, q_pos, kv_pos, causal, block_q, block_kv)
        B, _, bq, H, D = qb.shape
        Hkv = k.shape[2]
        g = H // Hkv
        pq = nq * bq - Tq
        dob = _pad_t(do.float(), pq).reshape(B, nq, bq, Hkv, g, D)
        outb = _pad_t(out.float(), pq).reshape(B, nq, bq, H, D)
        delta = (dob.reshape(B, nq, bq, H, D) * outb).sum(-1).transpose(2, 3)
        qg = qb.reshape(B, nq, bq, Hkv, g, D).float()
        dq = torch.zeros((B, nq, bq, Hkv, g, D), dtype=torch.float32, device=q.device)
        dks, dvs = [], []
        for j in range(nk):
            kj, vj = kb[:, j].float(), vb[:, j].float()
            s = _block_scores(qb, kb[:, j], qs, ks[:, j], qp, kp[:, j], causal=causal,
                              window=window, scale=scale)
            p = torch.exp(s - m[..., None]) * (s > NEG_INF / 2) / l[..., None]
            pg = p.reshape(B, nq, Hkv, g, bq, -1)
            dvs.append(torch.einsum("bnhgqk,bnqhgd->bkhd", pg, dob))
            dp = torch.einsum("bnqhgd,bkhd->bnhgqk", dob, vj)
            ds = pg * (dp - delta.reshape(B, nq, Hkv, g, bq, 1)) * scale
            dq = dq + torch.einsum("bnhgqk,bkhd->bnqhgd", ds, kj)
            dks.append(torch.einsum("bnhgqk,bnqhgd->bkhd", ds, qg))
        dq = dq.reshape(B, nq * bq, H, D)[:, :Tq].to(q.dtype)
        dk = torch.cat(dks, dim=1)[:, :Tkv].to(k.dtype)
        dv = torch.cat(dvs, dim=1)[:, :Tkv].to(v.dtype)
        return dq, dk, dv, *([None] * 9)


def _flash(q, k, v, q_seg, kv_seg, q_pos, kv_pos, *, causal, window, block_q,
           block_kv):
    """The JAX package's ``_pallas_flash`` contract: pad T to tile
    multiples with segment 0 (masked out), run the kernel in the
    ``[B, H, T, D]`` layout, slice the padded query rows off.  K/V take
    q's dtype (a bf16 cache under an fp32 model converts exactly).  The
    same copy zero-pads D to the kernels' size (``pad_head_dim``) and
    the scores keep the true D's scale; the padded output columns are
    sliced off, so autograd returns dq/dk/dv at the true D.  On either
    device."""
    B, Tq, H, D = q.shape
    Tkv = k.shape[1]
    bq = min(block_q, round_up(Tq, 8))
    bk = min(block_kv, round_up(Tkv, 8))
    pad_q = round_up(Tq, bq) - Tq
    pad_k = round_up(Tkv, bk) - Tkv
    (qp,), scale = pad_head_dim([q], 0, 0, 0, pad_q)
    kvp, _ = pad_head_dim([k.to(q.dtype), v.to(q.dtype)], 0, 0, 0, pad_k)

    def padt(x, n):
        return F.pad(x.to(torch.int32), (0, n))

    out = flash_attention_op(
        *(x.transpose(1, 2).contiguous() for x in (qp, *kvp)),
        padt(q_seg, pad_q), padt(kv_seg, pad_k), padt(q_pos, pad_q),
        padt(kv_pos, pad_k), causal=causal, window=None if window is None else int(window),
        scale=scale)
    return out.transpose(1, 2)[:, :Tq, :, :D]


def attention(q, k, v, *, q_seg, kv_seg, q_pos, kv_pos, causal: bool = True,
              window: int | None = None, backend: str = "chunked",
              block_q: int = 512, block_kv: int = 512) -> torch.Tensor:
    """Segment-aware GQA attention behind a selectable ``backend``.
    Returns [B,Tq,H,D]."""
    if q.shape[2] % k.shape[2] != 0:
        raise ValueError(f"n_heads {q.shape[2]} not multiple of kv heads {k.shape[2]}")
    scale = 1.0 / math.sqrt(q.shape[-1])
    if backend == "reference":
        mask = make_segment_mask(q_seg, kv_seg, q_pos, kv_pos, causal=causal,
                                 window=window)
        return _reference(q, k, v, mask, scale)
    if backend in ("flash", "flash_interpret"):
        return _flash(q, k, v, q_seg, kv_seg, q_pos, kv_pos, causal=causal,
                      window=window, block_q=block_q, block_kv=block_kv)
    if backend in ("chunked", "chunked_unrolled"):
        ints = (t.to(torch.int32) for t in (q_seg, kv_seg, q_pos, kv_pos))
        return _Chunked.apply(q, k, v, *ints, causal, window, scale, block_q, block_kv)
    raise ValueError(f"unknown attention backend {backend!r}; the port runs "
                     f"{ATTENTION_BACKENDS}")
