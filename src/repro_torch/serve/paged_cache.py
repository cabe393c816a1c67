"""Paged KV cache: fixed-size token blocks + per-sequence block tables.

Port of ``repro.serve.paged_cache`` for GQA and MLA stacks (``attn_mlp``
and ``moe`` blocks) and RWKV-6 stacks.  Seq-indexed K/V lives in pools of
``block_size``-token blocks shared by all slots, per stack ``kp``/``vp`` of
shape ``(count, NB, bs, KV, Dh)``, or for MLA the latent ``ckvp (count, NB,
bs, kv_lora_rank)`` and rope key ``kpep (count, NB, bs, qk_rope_dim)``.

``kv_quant=True`` stores the pools as integer codes beside fp32 scale pools
in the same block geometry: ``kps``/``vps (count, NB, bs, KV)`` for GQA (one
scale per token-slot per KV head), ``ckvs``/``kpes (count, NB, bs)`` for MLA
(one per token-slot).  ``kv_bits=8`` stores int8 codes, ``kv_bits=4`` two
codes a byte in uint8 pools of half the feature width.  The layers quantize
on write and the kernels dequantize on read.
A host-side free-list allocator hands each sequence the blocks its tokens
need, recorded in a per-slot block table; releasing a finished sequence
returns its blocks at once, so cache memory scales with live tokens.

Block 0 of every pool is the reserved **trash block**: the tables of dead
slots point at it, so a full-batch decode step can include dead rows (they
write into trash and attend to garbage that is never read).  All layers
share one block table.  The device-facing view is attached to the cache tree
under the reserved key ``"_paged"``; the layers write the pools in place.

Ring layers (sliding-window or chunk-local attention, h2o-danube's) and
recurrent stacks keep per-slot leaves instead of pools, as the reference
does: a ring is already bounded by its window, so it stays in the
contiguous ring layout ``k``/``v (count, slots, W, KV, Dh)`` with ``kpos
(count, slots, W)`` (``nn.attention.init_attn_cache``; float whatever
``kv_quant`` says), and rwkv6 keeps its ``tm.S (count, slots, H, Dk, Dv)``
fp32 state and the token-shift carries ``tm.shift``/``cm.shift (count,
slots, 1, d)`` in the compute dtype.  ``reset_slot`` empties a slot's rows
at admission (``kpos`` to -1, everything else to 0); ``slice_slot`` gives the
one-row view an isolated prefill reads and writes.  The layers write the
slot's row in place through that view, so no merge follows (the reference
returns new leaves and merges them back).  Dead rows ride along in decode:
their state advances and is zeroed on the slot's next admission.

Invariants: a sequence's blocks appear in its table row in logical order
(so the gathered view equals the contiguous layout); unowned table entries
stay 0 (trash); the trash block is never freed; ``lens[slot]`` counts tokens
written for the slot.  Not ported yet: refcounts and copy-on-write, the
radix prompt cache, rollback/truncate, KV-block export/import and hymba's
per-slot leaves.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, AttnConfig, StackConfig
from repro_torch.nn.attention import TRASH_BLOCK, init_attn_cache

__all__ = ["PagedKVCache", "init_paged_attn_cache", "init_paged_stack_cache", "POOL_KEYS",
           "TRASH_BLOCK"]

# leaves indexed by block (shared by all slots); every other leaf is per slot
POOL_KEYS = frozenset({"kp", "vp", "ckvp", "kpep", "kps", "vps", "ckvs", "kpes"})


def _code_shape(dim: int, kv_bits: int) -> tuple[int, ...]:
    """Feature width of a code pool: int8 keeps the width, int4 packs two
    codes a byte (an even feature dim)."""
    if kv_bits == 8:
        return (dim,)
    if kv_bits == 4:
        if dim % 2:
            raise ValueError(f"int4 KV packing needs an even feature dim, got {dim}")
        return (dim // 2,)
    raise ValueError(f"kv_bits must be 8 or 4, got {kv_bits}")


def init_paged_attn_cache(a: AttnConfig, num_blocks: int, block_size: int, dtype,
                          device, count: int = 1, kv_quant: bool = False,
                          kv_bits: int = 8, slots: int = 1, max_seq: int = 512) -> dict:
    """Paged pools for ``count`` stacked GQA or MLA layers: ``dtype`` pools,
    or with ``kv_quant`` integer code pools (int8, or packed int4 in uint8)
    and their fp32 scale pools.  A sliding-window or chunk-local GQA layer
    keeps its per-slot ring instead, ``dtype`` whatever ``kv_quant`` says
    (``init_attn_cache`` for ``slots`` rows, stacked ``count`` times)."""
    lead = (count, num_blocks, block_size)
    code = (torch.int8 if kv_bits == 8 else torch.uint8) if kv_quant else dtype

    def pool(*heads, dim):
        width = _code_shape(dim, kv_bits) if kv_quant else (dim,)
        return torch.zeros(lead + heads + width, dtype=code, device=device)

    def scales(*heads):
        return torch.zeros(lead + heads, dtype=torch.float32, device=device)

    if a.kind == "mla":
        pools = {"ckvp": pool(dim=a.kv_lora_rank), "kpep": pool(dim=a.qk_rope_dim)}
        if kv_quant:
            pools.update(ckvs=scales(), kpes=scales())
        return pools
    if (a.window or a.chunk) is not None:
        ring = init_attn_cache(slots, a, max_seq, dtype, device=device)
        return {k: torch.stack([v] * count) for k, v in ring.items()}
    pools = {"kp": pool(a.kv_heads, dim=a.head_dim), "vp": pool(a.kv_heads, dim=a.head_dim)}
    if kv_quant:
        pools.update(kps=scales(a.kv_heads), vps=scales(a.kv_heads))
    return pools


def init_paged_stack_cache(arch: ArchConfig, s: StackConfig, slots: int, num_blocks: int,
                           block_size: int, dtype, device, kv_quant: bool = False,
                           kv_bits: int = 8, max_seq: int = 512) -> dict:
    """One stack's cache leaves, each with a leading ``count`` axis: paged
    attention pools or per-slot rings, or rwkv6's per-slot recurrent
    leaves."""
    if s.kind in ("attn_mlp", "moe"):
        return {"attn": init_paged_attn_cache(s.attn, num_blocks, block_size, dtype, device,
                                              count=s.count, kv_quant=kv_quant, kv_bits=kv_bits,
                                              slots=slots, max_seq=max_seq)}
    if s.kind == "rwkv6":
        H, Dk = arch.d_model // s.ssm.head_dim, s.ssm.head_dim

        def shift():
            return torch.zeros((s.count, slots, 1, arch.d_model), dtype=dtype, device=device)

        return {"tm": {"S": torch.zeros((s.count, slots, H, Dk, Dk), dtype=torch.float32,
                                        device=device),
                       "shift": shift()},
                "cm": {"shift": shift()}}
    raise NotImplementedError(f"paged cache for {s.kind!r} stacks is not ported yet")


def _map_slot_leaves(tree: dict, fn) -> dict:
    """``tree`` with ``fn`` applied to every per-slot (non-pool) leaf."""
    return {k: _map_slot_leaves(v, fn) if isinstance(v, dict) else v if k in POOL_KEYS else fn(v)
            for k, v in tree.items()}


class PagedKVCache:
    """Device pools + host-side block-table allocator for ``slots`` sequences
    (integer code pools with ``kv_quant``, at ``kv_bits`` 8 or 4)."""

    def __init__(
        self,
        arch: ArchConfig,
        slots: int,
        *,
        block_size: int = 16,
        num_blocks: Optional[int] = None,
        max_seq: int = 512,
        dtype=torch.bfloat16,
        device="cpu",
        kv_quant: bool = False,
        kv_bits: int = 8,
    ):
        if kv_bits not in (8, 4):
            raise ValueError(f"kv_bits must be 8 or 4, got {kv_bits}")
        self.kv_quant = kv_quant
        self.kv_bits = kv_bits if kv_quant else 8
        self.arch = arch
        self.slots = slots
        self.block_size = block_size
        self.max_seq = max_seq
        self.device = torch.device(device)
        self.max_blocks_per_seq = -(-max_seq // block_size)
        if num_blocks is None:
            # worst case every slot runs to max_seq, plus the trash block
            num_blocks = slots * self.max_blocks_per_seq + 1
        if num_blocks < 2:
            raise ValueError("need at least one non-trash block")
        self.num_blocks = num_blocks
        self.pools = {
            str(i): init_paged_stack_cache(arch, s, slots, num_blocks, block_size, dtype,
                                           self.device, kv_quant=kv_quant, kv_bits=kv_bits,
                                           max_seq=max_seq)
            for i, s in enumerate(arch.stacks)
        }
        # LIFO free list; low ids handed out first so fresh tables are ordered
        self.free = list(range(num_blocks - 1, TRASH_BLOCK, -1))
        self.tables = np.zeros((slots, self.max_blocks_per_seq), np.int32)
        self.lens = np.zeros((slots,), np.int32)
        self._owned: list[list[int]] = [[] for _ in range(slots)]
        self.peak_blocks = 0  # high-water mark of simultaneously owned blocks

    def reset_counters(self) -> None:
        self.peak_blocks = 0

    # -- allocator ----------------------------------------------------------

    def blocks_needed(self, n_tokens: int) -> int:
        return -(-n_tokens // self.block_size)

    @property
    def free_blocks(self) -> int:
        return len(self.free)

    def allocated_blocks(self) -> int:
        return self.num_blocks - 1 - len(self.free)

    def allocate(self, slot: int, n_tokens: int) -> None:
        """Grow ``slot``'s table to cover ``n_tokens`` total tokens."""
        need = self.blocks_needed(n_tokens)
        if need > self.max_blocks_per_seq:
            raise ValueError(f"sequence of {n_tokens} tokens exceeds max_seq={self.max_seq}")
        owned = self._owned[slot]
        while len(owned) < need:
            if not self.free:
                raise RuntimeError("paged KV cache out of blocks")
            b = self.free.pop()
            self.tables[slot, len(owned)] = b
            owned.append(b)
        self.peak_blocks = max(self.peak_blocks, self.allocated_blocks())

    def release(self, slot: int) -> None:
        self.free.extend(reversed(self._owned[slot]))
        self._owned[slot] = []
        self.tables[slot] = TRASH_BLOCK
        self.lens[slot] = 0

    def _leaves(self, pools: bool):
        def walk(tree):
            for k, v in tree.items():
                if isinstance(v, dict):
                    yield from walk(v)
                elif (k in POOL_KEYS) == pools:
                    yield v
        return walk(self.pools)

    def kv_bytes_per_token(self) -> int:
        """Device bytes one cached token costs across every pool (all layers;
        codes and scale pools); 0 for a stack without pools (rwkv6, or one
        whose every layer is a ring).  Rings and recurrent leaves do not
        grow with tokens and are left out, as the reference leaves them."""
        return sum(leaf[0, 0, 0].numel() * leaf.element_size() * leaf.shape[0]
                   for leaf in self._leaves(pools=True))

    def state_bytes_per_slot(self) -> int:
        """Device bytes of one slot's per-slot leaves across all layers (rings'
        ``k``/``v``/``kpos``; rwkv6's fp32 state and token-shift carries);
        they do not grow with tokens."""
        return sum(leaf[:, 0].numel() * leaf.element_size() for leaf in self._leaves(pools=False))

    # -- per-slot state (recurrent leaves) ------------------------------------

    def reset_slot(self, slot: int) -> None:
        """Empty ``slot``'s rows of every per-slot leaf, so a fresh sequence
        starts from an empty ring and a zero recurrent state whatever the
        slot's previous occupant (or a dead row's ride through decode) left:
        a ring's ``kpos`` to -1 (a zero there would make a stale key valid at
        position 0), every other leaf to 0."""
        def walk(tree):
            for k, v in tree.items():
                if isinstance(v, dict):
                    walk(v)
                elif k not in POOL_KEYS:
                    v[:, slot].fill_(-1 if k == "kpos" else 0)

        walk(self.pools)

    def slice_slot(self, slot: int) -> dict:
        """The cache tree an isolated prefill of ``slot`` runs on: pools whole
        (the slot's blocks live there), per-slot leaves as one-row views
        ``(count, 1, ...)`` written in place.  Pair with ``bt_row(slot)``."""
        return _map_slot_leaves(self.pools, lambda leaf: leaf[:, slot:slot + 1])

    # -- device view --------------------------------------------------------

    def bt(self) -> torch.Tensor:
        """Full block table ``(slots, MB)`` as a device tensor."""
        return torch.tensor(self.tables, device=self.device)

    def bt_row(self, slot: int) -> torch.Tensor:
        """Single-row block-table view ``(1, MB)`` for an isolated prefill."""
        return torch.tensor(self.tables[slot : slot + 1], device=self.device)
