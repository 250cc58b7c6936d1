"""Block attention: flash partials for one K/V block, as a Hopper kernel.

Ports `vtpu_manager/workloads/pallas_attention.py` (`attention_block:57`,
`make_pallas_block_fn:101`, `combine_blocks:112`). The TPU kernel
(`_attn_block_kernel:28`) becomes `csrc/attn_block.cu`, a CUDA C++ kernel
for sm_90a loaded over ctypes; its plain version is
`ring_attention.block_partials`.

`attention_block` takes what the JAX function takes, in the same layout,
and returns the same (o unnormalised fp32, m, l) triple. A tensor on the
CPU goes to the plain version; a tensor on the card launches the kernel or
raises. `attn_block_op` is the same function as a custom operator
(`torch.ops.vtpu.attn_block`), which `torch.compile` keeps whole in its
graph. `LAUNCHES` counts the kernel's launches and nothing else.
"""

from __future__ import annotations

import ctypes

import torch

from vtpu_manager_torch.workloads.ring_attention import (block_partials,
                                                         merge_partials)

MAX_HEAD_DIM = 128
MAX_BATCH_HEADS = 65535          # the kernel's grid.y
LAUNCHES = {"attn_block": 0}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def _kernel():
    """The built kernel library, bound with ctypes (built at first use)."""
    global _lib
    if _lib is None:
        from vtpu_manager_torch.build import build_attn_kernel
        lib = ctypes.CDLL(str(build_attn_kernel()))
        fn = lib.attn_block_forward
        fn.argtypes = ([ctypes.c_void_p] * 7
                       + [ctypes.c_int] * 4
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           bias: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or bias.dim() != 2:
        raise ValueError("expected q, k, v [B,H,S,D] and bias [Sq,Sk]")
    b, h, sq, d = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if tuple(bias.shape) != (sq, k.shape[2]):
        raise ValueError(f"bias {tuple(bias.shape)} is not [Sq, Sk] = "
                         f"{(sq, k.shape[2])}")


def attention_block(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q,k,v: [B, H, S, D]; bias: [Sq, Sk] additive (0 or -inf). Returns
    the flash-style partials (o_unnorm fp32, m, l) for one block."""
    _check(q, k, v, bias)
    if q.device.type == "cpu":
        return block_partials(q.float(), k.float(), v.float(), bias.float())
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    for name, t in (("k", k), ("v", v), ("bias", bias)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share float32 or bfloat16, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    if bias.dtype != torch.float32:
        raise ValueError(f"bias must be float32, got {bias.dtype}")
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} outside 1..{MAX_HEAD_DIM}")
    if not 1 <= b * h <= MAX_BATCH_HEADS or sq < 1 or sk < 1:
        raise ValueError(f"shape {tuple(q.shape)} / Sk={sk} not launchable")

    o = torch.empty((b, h, sq, d), dtype=torch.float32, device=q.device)
    m = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    l = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _kernel().attn_block_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            o.data_ptr(), m.data_ptr(), l.data_ptr(), b * h, sq, sk, d,
            d ** -0.5, _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"attn_block launch failed: cudaError_t {err}")
    LAUNCHES["attn_block"] += 1
    return o, m, l


@torch.library.custom_op("vtpu::attn_block", mutates_args=())
def attn_block_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  bias: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`attention_block` as an operator a compiled graph calls as it is
    (`torch.ops.vtpu.attn_block`): Dynamo traces it through the fake below
    with no graph break, and the compiled code calls back here, so the
    rule stays: the plain version for CPU tensors, the kernel or an error
    on the card."""
    return attention_block(q, k, v, bias)


@attn_block_op.register_fake
def _attn_block_fake(q, k, v, bias):
    _check(q, k, v, bias)
    b, h, sq, d = q.shape
    return (q.new_empty((b, h, sq, d), dtype=torch.float32),
            q.new_empty((b, h, sq), dtype=torch.float32),
            q.new_empty((b, h, sq), dtype=torch.float32))


def make_block_fn():
    """block_fn for the ring: the kernel in place of block_partials."""
    return attention_block


def combine_blocks(partials: list[tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]],
                   out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Merge flash partials from several K/V blocks into the final
    normalized attention output (merge math lives in ring_attention)."""
    o_acc, m_acc, l_acc = partials[0]
    for o, m, l in partials[1:]:
        o_acc, m_acc, l_acc = merge_partials(o_acc, m_acc, l_acc, o, m, l)
    l_acc = torch.where(l_acc == 0.0, torch.ones_like(l_acc), l_acc)
    return (o_acc / l_acc[..., None]).to(out_dtype)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
