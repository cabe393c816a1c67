"""Paged KV cache: fixed-size token blocks + per-sequence block tables.

Port of ``repro.serve.paged_cache`` for GQA and MLA stacks (``attn_mlp``
and ``moe`` blocks), RWKV-6 stacks and hymba stacks.  Seq-indexed K/V lives in pools of
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

Ring layers (sliding-window or chunk-local attention: h2o-danube's,
hymba's, llama4's local layers) and recurrent stacks keep per-slot leaves instead of pools, as the reference
does: a ring is already bounded by its window, so it stays in the
contiguous ring layout ``k``/``v (count, slots, W, KV, Dh)`` with ``kpos
(count, slots, W)`` (``nn.attention.init_attn_cache``; float whatever
``kv_quant`` says), and rwkv6 keeps its ``tm.S (count, slots, H, Dk, Dv)``
fp32 state and the token-shift carries ``tm.shift``/``cm.shift (count,
slots, 1, d)`` in the compute dtype; hymba its window's ring beside the
mamba heads' fp32 SSD state ``mamba.S (count, slots, H, Dh, N)``.  ``reset_slot`` empties a slot's rows
at admission (``kpos`` to -1, everything else to 0); ``slice_slot`` gives the
one-row view an isolated prefill reads and writes.  The layers write the
slot's row in place through that view, so no merge follows (the reference
returns new leaves and merges them back).  Dead rows ride along in decode:
their state advances and is zeroed on the slot's next admission.

Sharing and rollback, the reference's substrate for prefix sharing and
speculative decoding (host logic copied over with its semantics):

* every block carries a **refcount**: a fresh allocation starts at 1, prefix
  adoption (``adopt_prefix``) and a radix node's pin add one, release and
  truncate take one away, and a block returns to the free list only at 0;
* **copy-on-write**: before any write into a token span the engine calls
  ``ensure_writable(slot, start, end)``; each covered block with refcount > 1
  is replaced by a private copy.  The copies are made **in place**: all
  faulting pairs of one call go into one ``index_copy_`` per pool leaf on the
  block axis, every source gathered before any destination is written, so
  no pool tensor is ever rebound (the megastep's CUDA graph reads every pool
  at a fixed address; the reference rebuilds its pool pytree instead);
* **watermarks**: ``watermarks[slot]`` is the high-water write position
  (set by ``ensure_writable``); ``rollback(slot, n)`` rewinds only ``lens``
  (the speculative round's unwind, keeping the admission reservation), and
  ``truncate(slot, n)`` also drops surplus blocks in reverse ownership order,
  so undoing an allocation restores the free list exactly;
* a host-side **radix prompt cache**: each node owns one full block of
  ``block_size`` prompt tokens, keyed under its parent by the chunk's token
  tuple and pinned by the node's own refcount, so a cached prefix outlives
  its donor.  ``lookup_prefix`` returns the longest match (capped at
  ``len(prompt) - 1``), including a partial match into the next block;
  ``adopt_prefix`` maps it into an empty slot.  Eviction (``reclaim`` under
  block pressure, or at ``max_prefix_entries`` unpinned nodes) takes leaves
  only, lowest ``hits * covered tokens`` first, ties least recently used;
  nodes registered ``pinned=True`` (``pin_prompt``) are never evicted.
  Only a ``fully_paged`` cache (every seq-indexed leaf in block pools: no
  ring, no recurrent state) registers anything.

Invariants: a sequence's blocks appear in its table row in logical order
(so the gathered view equals the contiguous layout); live slots share a
block only while every sharer treats it read-only; unowned table entries
stay 0 (trash); the trash block is never refcounted and never freed;
``lens[slot]`` counts tokens written for the slot and ``watermarks[slot] >=
lens[slot]`` bounds where garbage from rolled-back writes may sit.

KV-block migration (prefill/decode disaggregation; fully paged caches only):
``export_blocks`` gathers a slot's written blocks on the device and makes one
host copy a pool leaf, at storage width (fp32 pools as fp32, int8 codes as
int8, packed int4 as uint8, scales as fp32; a bf16 pool, which numpy has no
type for, as its raw bits in uint16); the payload records each leaf's dtype
(``dtypes``) beside the reference's fields, its leaves keyed by the
reference's ``jax.tree_util.keystr`` strings (``"['0']['attn']['kp']"``).
``import_blocks`` validates the geometry and every leaf's dtype and shape
and writes the blocks **in place**, one ``index_copy_`` a pool leaf, never
converting a leaf: no pool tensor is rebound.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig, AttnConfig, StackConfig
from repro_torch.nn.attention import TRASH_BLOCK, init_attn_cache
from repro_torch.nn.ssm import init_mamba_state

__all__ = ["PagedKVCache", "init_paged_attn_cache", "init_paged_stack_cache", "POOL_KEYS",
           "TRASH_BLOCK"]

# leaves indexed by block (shared by all slots); every other leaf is per slot
POOL_KEYS = frozenset({"kp", "vp", "ckvp", "kpep", "kps", "vps", "ckvs", "kpes"})

# numpy carriers of the pool dtypes on the migration wire: bf16 ships as its bits
_WIRE_NP = {torch.float32: np.float32, torch.bfloat16: np.uint16, torch.int8: np.int8,
            torch.uint8: np.uint8}


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _to_wire(t: torch.Tensor) -> np.ndarray:
    """One host copy of ``t`` as numpy at storage width (bf16 as its bits)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view(np.uint16)
    return t.cpu().numpy()


def _from_wire(arr: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """A wire array back as a host tensor of ``dtype`` (the bits viewed, never
    converted)."""
    if not (arr.flags.c_contiguous and arr.flags.writeable):
        arr = np.array(arr, copy=True)
    if dtype == torch.bfloat16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class _RadixNode:
    """One cached block of the radix prompt cache: ``key`` is the block's
    token chunk (the child key under ``parent``), ``block`` the pinned pool
    block holding those tokens' K/V.  ``hits``/``last_used`` feed the
    LRU/cost eviction; ``pinned`` nodes are never evicted."""

    __slots__ = ("key", "block", "parent", "children", "hits", "last_used", "depth_tokens",
                 "pinned")

    def __init__(self, key, block, parent, depth_tokens):
        self.key = key  # tuple of block_size token ids
        self.block = block
        self.parent = parent
        self.children: dict[tuple, "_RadixNode"] = {}
        self.hits = 0
        self.last_used = 0
        self.depth_tokens = depth_tokens  # prompt tokens a hit on this node serves
        self.pinned = False


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
    attention pools or per-slot rings, rwkv6's per-slot recurrent leaves, or
    hymba's ring and per-slot SSD state."""
    if s.kind in ("attn_mlp", "moe", "hymba"):
        cache = {"attn": init_paged_attn_cache(s.attn, num_blocks, block_size, dtype, device,
                                               count=s.count, kv_quant=kv_quant,
                                               kv_bits=kv_bits, slots=slots, max_seq=max_seq)}
        if s.kind == "hymba":
            cache["mamba"] = init_mamba_state(arch.d_model, s.ssm, s.count, slots, device)
        return cache
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
    (integer code pools with ``kv_quant``, at ``kv_bits`` 8 or 4), with
    refcounted copy-on-write blocks, rollback and the radix prompt cache."""

    def __init__(
        self,
        arch: ArchConfig,
        slots: int,
        *,
        block_size: int = 16,
        num_blocks: Optional[int] = None,
        max_seq: int = 512,
        dtype=torch.bfloat16,
        device="cuda",
        kv_quant: bool = False,
        kv_bits: int = 8,
        max_prefix_entries: int = 32,
    ):
        if kv_bits not in (8, 4):
            raise ValueError(f"kv_bits must be 8 or 4, got {kv_bits}")
        self.kv_quant = kv_quant
        self.kv_bits = kv_bits if kv_quant else 8
        self.arch = arch
        self.slots = slots
        self.block_size = block_size
        self.max_seq = max_seq
        self.device = resolve_device(device)
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
        # high-water write position per slot: rollback/truncate rewind lens
        # and leave it, so [lens, watermark) may hold rejected writes' garbage
        self.watermarks = np.zeros((slots,), np.int32)
        self._owned: list[list[int]] = [[] for _ in range(slots)]
        # fresh allocation = 1, adoption and radix pins add one, release and
        # truncate take one away; on the free list iff 0 (trash stays 0)
        self.refcounts = np.zeros((num_blocks,), np.int32)
        self.peak_blocks = 0  # high-water mark of simultaneously owned blocks
        self.cow_copies = 0  # copy-on-write block copies
        self.pool_rebuilds = 0  # batched in-place pool writes (copy-on-write, block imports)
        self.prefix_hits = 0  # admissions that adopted a shared prefix
        self.prefix_hit_tokens = 0  # prompt tokens served from shared blocks
        # KV-block migration (disaggregation): blocks and wire bytes exported
        # to / imported from a peer cache, at storage width
        self.migrated_blocks_out = 0
        self.migrated_blocks_in = 0
        self.migration_bytes_out = 0
        self.migration_bytes_in = 0
        # radix prompt cache: _block_pins counts nodes per block (for the
        # freed-block assert), _entry_rc the refcount the nodes hold;
        # max_prefix_entries caps the unpinned nodes
        self.max_prefix_entries = max_prefix_entries
        self._radix_root = _RadixNode((), TRASH_BLOCK, None, 0)
        self._block_pins: dict[int, int] = {}
        self._entry_rc = np.zeros((num_blocks,), np.int32)
        self._radix_clock = 0  # logical LRU clock
        self._radix_nodes = 0
        self._radix_unpinned = 0
        # every seq-indexed leaf lives in pools (no ring / recurrent per-slot
        # leaves): the precondition for prefix sharing and spec rollback
        self.fully_paged = not any(True for _ in self._leaves(pools=False))

    # -- counters ------------------------------------------------------------

    _COUNTER_FIELDS = ("peak_blocks", "cow_copies", "pool_rebuilds", "prefix_hits",
                       "prefix_hit_tokens", "migrated_blocks_out", "migrated_blocks_in",
                       "migration_bytes_out", "migration_bytes_in")

    def counters(self) -> dict:
        """Every cache event counter as one dict."""
        return {k: getattr(self, k) for k in self._COUNTER_FIELDS}

    def reset_counters(self) -> None:
        for k in self._COUNTER_FIELDS:
            setattr(self, k, 0)

    # -- allocator ----------------------------------------------------------

    def blocks_needed(self, n_tokens: int) -> int:
        return -(-n_tokens // self.block_size)

    @property
    def free_blocks(self) -> int:
        return len(self.free)

    def allocated_blocks(self) -> int:
        return self.num_blocks - 1 - len(self.free)

    def _pop_free(self, what: str) -> int:
        """A free block, evicting prompt-cache nodes first if none is free."""
        if not self.free:
            self.reclaim(1)
        if not self.free:
            raise RuntimeError(f"paged KV cache out of blocks{what}")
        return self.free.pop()

    def allocate(self, slot: int, n_tokens: int) -> None:
        """Grow ``slot``'s table to cover ``n_tokens`` total tokens."""
        need = self.blocks_needed(n_tokens)
        if need > self.max_blocks_per_seq:
            raise ValueError(f"sequence of {n_tokens} tokens exceeds max_seq={self.max_seq}")
        owned = self._owned[slot]
        while len(owned) < need:
            b = self._pop_free("")
            self.tables[slot, len(owned)] = b
            owned.append(b)
            self.refcounts[b] = 1
        self.peak_blocks = max(self.peak_blocks, self.allocated_blocks())

    def _drop_block(self, slot: int, idx: int) -> Optional[int]:
        """Take one from the refcount of ``slot``'s ``idx``-th block and clear
        its table entry; returns the block if it just became free."""
        b = self._owned[slot][idx]
        self.tables[slot, idx] = TRASH_BLOCK
        self.refcounts[b] -= 1
        assert self.refcounts[b] >= 0, "refcount underflow"
        return b if self.refcounts[b] == 0 else None

    def _free_and_purge(self, freed: list) -> None:
        self.free.extend(freed)
        for b in freed:
            # a cached block is pinned by its node's own refcount, so it can
            # reach zero only after eviction unmapped its node
            assert b not in self._block_pins, "freed a registry-pinned block"

    def release(self, slot: int) -> None:
        freed = [b for b in (self._drop_block(slot, idx)
                             for idx in reversed(range(len(self._owned[slot]))))
                 if b is not None]
        self._free_and_purge(freed)
        self._owned[slot] = []
        self.tables[slot] = TRASH_BLOCK
        self.lens[slot] = 0
        self.watermarks[slot] = 0

    def rollback(self, slot: int, n_tokens: int) -> None:
        """Lens-only rewind of ``slot``'s write position to ``n_tokens``,
        block ownership untouched: the speculative round's unwind, which
        must keep the request's admission reservation (a block freed mid
        flight could go to a later admission, and the plain fallback would
        then write into trash).  Entries in ``[n_tokens, watermark)`` keep
        their garbage; the position masks hide them until overwritten."""
        assert n_tokens <= self.lens[slot] or n_tokens <= self.watermarks[slot]
        self.lens[slot] = n_tokens

    def truncate(self, slot: int, n_tokens: int) -> None:
        """Retire ``slot``'s capacity beyond ``n_tokens``: surplus blocks are
        dropped in reverse ownership order (LIFO-symmetric with ``allocate``,
        so undoing a fresh allocation restores the free list exactly, order
        included) and ``lens`` resets."""
        need = self.blocks_needed(n_tokens)
        owned = self._owned[slot]
        freed = []
        while len(owned) > need:
            b = self._drop_block(slot, len(owned) - 1)
            owned.pop()
            if b is not None:
                freed.append(b)
        self._free_and_purge(freed)
        self.lens[slot] = n_tokens

    # -- copy-on-write --------------------------------------------------------

    def ensure_writable(self, slot: int, start: int, end: int) -> None:
        """Make the token span ``[start, end)`` of ``slot`` safe to write: each
        covered block with refcount > 1 (shared through ``adopt_prefix``) is
        replaced by a private copy before any write sees the table, all of
        one call's faults in one batched copy (``_copy_blocks``).  Advances
        the slot's watermark.  A no-op on unshared spans."""
        if end <= start:
            return
        self.watermarks[slot] = max(int(self.watermarks[slot]), end)
        bs = self.block_size
        pairs: list[tuple[int, int]] = []
        # a megastep window's preflight may name a span past the slot's table
        # (lens + N at the drain tail); those positions are never written, so
        # clamp rather than index out of the table
        j_hi = min((end - 1) // bs, self.tables.shape[1] - 1)
        for j in range(start // bs, j_hi + 1):
            b = int(self.tables[slot, j])
            if b == TRASH_BLOCK or self.refcounts[b] <= 1:
                continue
            nb = self._pop_free(" for CoW copy")
            pairs.append((b, nb))
            self.refcounts[b] -= 1
            self.refcounts[nb] = 1
            self.tables[slot, j] = nb
            self._owned[slot][j] = nb
        if pairs:
            self._copy_blocks(pairs)
            self.cow_copies += len(pairs)
        self.peak_blocks = max(self.peak_blocks, self.allocated_blocks())

    def _copy_blocks(self, pairs: list) -> None:
        """Copy every ``(src, dst)`` block pair in place, one ``index_copy_``
        per pool leaf on the block axis: each leaf's sources are gathered
        (``index_select``, a new tensor) before any destination is written,
        and no pool tensor is rebound.  The destinations are fresh off the
        free list, so no pair reads another's write."""
        src = torch.tensor([p[0] for p in pairs], dtype=torch.long, device=self.device)
        dst = torch.tensor([p[1] for p in pairs], dtype=torch.long, device=self.device)
        for leaf in self._leaves(pools=True):
            leaf.index_copy_(1, dst, leaf.index_select(1, src))
        self.pool_rebuilds += 1

    # -- prefix sharing -------------------------------------------------------

    def _touch(self, node: _RadixNode, hit: bool) -> None:
        self._radix_clock += 1
        node.last_used = self._radix_clock
        if hit:
            node.hits += 1

    def register_prefix(self, slot: int, tokens, pinned: bool = False) -> None:
        """Publish ``slot``'s prompt blocks into the radix prompt cache: each
        block wholly covered by ``tokens`` becomes (or joins) a node keyed by
        its token chunk; a new node pins the slot's block with its own
        refcount, an existing one deduplicates.  Only full blocks: the donor
        writes at positions >= len(prompt) only, so it never faults a pinned
        block (copy-on-write stays on the adopter's side, which the admission
        gate budgets).  ``pinned=True`` marks the chain permanent and keeps
        it out of the node cap."""
        if not self.fully_paged:
            return
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        n_full = tokens.size // self.block_size
        if n_full == 0 or tokens.size < 2:
            return  # nothing shareable below a full block / the len-1 cap
        cur = self._radix_root
        path = {id(cur)}
        for j in range(n_full):
            key = tuple(int(t) for t in tokens[j * self.block_size:(j + 1) * self.block_size])
            child = cur.children.get(key)
            if child is None:
                # the cap counts unpinned nodes; evict around the insertion
                # path so the chain being extended is never orphaned
                while not pinned and self._radix_unpinned >= self.max_prefix_entries:
                    if not self._evict_one(protect=path):
                        return  # everything else is pinned: stop inserting
                b = self._owned[slot][j]
                child = _RadixNode(key, b, cur, (j + 1) * self.block_size)
                child.pinned = pinned
                cur.children[key] = child
                self._block_pins[b] = self._block_pins.get(b, 0) + 1
                self.refcounts[b] += 1
                self._entry_rc[b] += 1
                self._radix_nodes += 1
                if not pinned:
                    self._radix_unpinned += 1
            elif pinned and not child.pinned:
                # pinning promotes the chain; the node leaves the cap's count
                child.pinned = True
                self._radix_unpinned -= 1
            self._touch(child, hit=False)
            cur = child
            path.add(id(cur))

    def _evict_one(self, protect: Optional[set] = None) -> bool:
        """Evict the lowest-value evictable leaf (``hits * covered_tokens``,
        ties least recently used); never a pinned node or one in
        ``protect``.  Its block returns to the free list iff no slot still
        owns it.  Returns whether a node was evicted."""
        protect = protect or set()
        best = None
        stack = list(self._radix_root.children.values())
        while stack:
            node = stack.pop()
            if node.children:
                stack.extend(node.children.values())
                continue
            if node.pinned or id(node) in protect:
                continue
            score = (node.hits * node.depth_tokens, node.last_used)
            if best is None or score < best[0]:
                best = (score, node)
        if best is None:
            return False
        node = best[1]
        node.parent.children.pop(node.key)
        pins = self._block_pins[node.block] - 1
        if pins:
            self._block_pins[node.block] = pins
        else:
            del self._block_pins[node.block]
        self._radix_nodes -= 1
        self._radix_unpinned -= 1
        self._entry_rc[node.block] -= 1
        self.refcounts[node.block] -= 1
        assert self.refcounts[node.block] >= 0, "refcount underflow on eviction"
        if self.refcounts[node.block] == 0:
            self.free.append(node.block)
        return True

    def reclaim(self, need: int) -> None:
        """Evict prompt-cache nodes (lowest value first) until ``need`` blocks
        are free or only pinned chains remain: live sequences win over cached
        prefixes."""
        while self.free_blocks < need and self._evict_one():
            pass

    def registry_size(self) -> int:
        """Cached radix nodes, pinned included."""
        return self._radix_nodes

    def registered_blocks(self) -> frozenset:
        """The block ids the prompt cache pins."""
        return frozenset(self._block_pins)

    def reclaimable_blocks(self) -> int:
        """Blocks a full ``reclaim`` would hand back: nodes in wholly
        evictable subtrees (a pinned descendant shields its ancestors) whose
        refcount is only the nodes' own.  The admission gate counts them as
        capacity, so this never overpromises."""

        def walk(node: _RadixNode) -> tuple[bool, int]:
            evictable, freed = True, 0
            for ch in node.children.values():
                ev, f = walk(ch)
                evictable &= ev
                freed += f
            evictable &= not node.pinned
            if evictable and self.refcounts[node.block] == self._entry_rc[node.block]:
                freed += 1
            return evictable, freed

        return sum(walk(ch)[1] for ch in self._radix_root.children.values())

    def lookup_prefix(self, tokens) -> tuple[int, tuple[int, ...]]:
        """Longest cached prefix of ``tokens``, capped at ``len(tokens) - 1``
        (prefill keeps a token to take logits from): one dict probe a full
        block down the tree, then the longest partial match into the deepest
        node's children.  Returns ``(shared_tokens, block_run)``; the run's
        last block may be partial (the adopter copies it on write)."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        cap = tokens.size - 1
        cur = self._radix_root
        blocks: list[int] = []
        d = 0
        while (d + 1) * self.block_size <= cap:
            key = tuple(int(t) for t in tokens[d * self.block_size:(d + 1) * self.block_size])
            child = cur.children.get(key)
            if child is None:
                break
            self._touch(child, hit=True)
            blocks.append(child.block)
            cur = child
            d += 1
        shared = d * self.block_size
        rest = tokens[shared:cap]
        if rest.size:
            best_m, best_child = 0, None
            for child in cur.children.values():
                key = np.asarray(child.key, np.int32)[:rest.size]
                neq = np.nonzero(rest[:key.size] != key)[0]
                m = int(neq[0]) if neq.size else key.size
                if m > best_m:
                    best_m, best_child = m, child
            if best_child is not None:
                self._touch(best_child, hit=True)
                blocks.append(best_child.block)
                shared += best_m
        return shared, tuple(blocks)

    def adopt_prefix(self, slot: int, shared_tokens: int, blocks) -> None:
        """Map a looked-up block run into the empty ``slot``: table entries
        point at the shared blocks (refcounts up one), ``lens`` and the
        watermark jump to ``shared_tokens``; nothing is copied until a write
        faults a block."""
        assert not self._owned[slot], "adopt_prefix needs an empty slot"
        for j, b in enumerate(blocks):
            self.tables[slot, j] = b
            self._owned[slot].append(b)
            self.refcounts[b] += 1
        self.lens[slot] = shared_tokens
        self.watermarks[slot] = shared_tokens
        self.prefix_hits += 1
        self.prefix_hit_tokens += shared_tokens
        self.peak_blocks = max(self.peak_blocks, self.allocated_blocks())

    def _leaves(self, pools: bool):
        return (leaf for _, leaf in self._leaves_with_keys(pools))

    def _leaves_with_keys(self, pools: bool):
        """``(key, leaf)`` pairs, ``key`` the reference's ``keystr`` of the
        leaf's path (``"['0']['attn']['kp']"``)."""
        def walk(tree, key):
            for k, v in tree.items():
                if isinstance(v, dict):
                    yield from walk(v, f"{key}[{k!r}]")
                elif (k in POOL_KEYS) == pools:
                    yield f"{key}[{k!r}]", v
        return walk(self.pools, "")

    # -- KV-block migration (prefill/decode disaggregation) --------------------

    def _migration_guard(self) -> None:
        if not self.fully_paged:
            raise ValueError(
                "KV-block migration needs a fully paged cache (no ring / "
                "recurrent per-slot leaves); this arch keeps per-slot state "
                "outside the block pools"
            )

    def export_blocks(self, slot: int) -> dict:
        """``slot``'s written KV as a host payload: for each pool leaf the
        blocks covering ``lens[slot]`` tokens, gathered on the device and
        copied to the host once, at storage width (``_to_wire``), plus the
        geometry ``import_blocks`` validates and each leaf's dtype.  The slot
        keeps its blocks: export is a read."""
        self._migration_guard()
        n_tok = int(self.lens[slot])
        if n_tok <= 0:
            raise ValueError(f"slot {slot} has no written tokens to export")
        need = self.blocks_needed(n_tok)
        ids = torch.tensor(self._owned[slot][:need], dtype=torch.long, device=self.device)
        leaves, dtypes = {}, {}
        for key, leaf in self._leaves_with_keys(pools=True):
            leaves[key] = _to_wire(leaf.index_select(1, ids))
            dtypes[key] = _dtype_name(leaf.dtype)
        self.migrated_blocks_out += need
        self.migration_bytes_out += sum(a.nbytes for a in leaves.values())
        return {
            "tokens": n_tok,
            "n_blocks": need,
            "block_size": self.block_size,
            "kv_quant": self.kv_quant,
            "kv_bits": self.kv_bits,
            "leaves": leaves,
            "dtypes": dtypes,
        }

    def import_blocks(self, slot: int, payload: dict) -> None:
        """Adopt an exported payload into the empty ``slot``: allocate fresh
        blocks for its token span, write every wire leaf into the local pool
        in place (one ``index_copy_`` a leaf on the block axis; the
        megastep's CUDA graph reads each pool at a fixed address) and set
        ``lens``/``watermarks`` so decode resumes at position ``tokens``.  The
        geometry and each leaf's dtype and shape must match this cache:
        nothing is converted or re-quantized, so codes land bit for bit.
        Every leaf is checked before anything is allocated or written."""
        self._migration_guard()
        for field in ("block_size", "kv_quant", "kv_bits"):
            if payload[field] != getattr(self, field):
                raise ValueError(
                    f"migration geometry mismatch: {field}="
                    f"{payload[field]!r} vs local {getattr(self, field)!r}"
                )
        assert not self._owned[slot], "import_blocks needs an empty slot"
        n_tok = int(payload["tokens"])
        n_blocks = self.blocks_needed(n_tok)
        if n_blocks != payload["n_blocks"]:
            raise ValueError(f"migration block count skew: {payload['n_blocks']} blocks for "
                             f"{n_tok} tokens of {self.block_size}")
        leaves = dict(payload["leaves"])
        writes = []
        for key, leaf in self._leaves_with_keys(pools=True):
            arr = leaves.pop(key)
            got = payload["dtypes"][key]
            want = (leaf.shape[0], n_blocks) + tuple(leaf.shape[2:])
            if (got != _dtype_name(leaf.dtype) or arr.dtype != _WIRE_NP[leaf.dtype]
                    or arr.shape != want):
                raise ValueError(
                    f"migration leaf mismatch at {key}: "
                    f"got {got}{arr.shape}, want {_dtype_name(leaf.dtype)}{want}"
                )
            writes.append((leaf, arr))
        if leaves:
            raise ValueError(f"payload has leaves unknown here: {sorted(leaves)}")
        self.allocate(slot, n_tok)
        idx = torch.tensor(self._owned[slot], dtype=torch.long, device=self.device)
        for leaf, arr in writes:
            leaf.index_copy_(1, idx, _from_wire(arr, leaf.dtype).to(self.device))
        self.pool_rebuilds += 1
        self.lens[slot] = n_tok
        self.watermarks[slot] = n_tok
        self.migrated_blocks_in += n_blocks
        self.migration_bytes_in += sum(a.nbytes for a in payload["leaves"].values())

    def kv_bytes_per_token(self) -> int:
        """Device bytes one cached token costs across every pool (all layers;
        codes and scale pools); 0 for a stack without pools (rwkv6, or one
        whose every layer is a ring).  Rings and recurrent leaves do not
        grow with tokens and are left out, as the reference leaves them."""
        return sum(leaf[0, 0, 0].numel() * leaf.element_size() * leaf.shape[0]
                   for leaf in self._leaves(pools=True))

    def state_bytes_per_slot(self) -> int:
        """Device bytes of one slot's per-slot leaves across all layers (rings'
        ``k``/``v``/``kpos``; rwkv6's fp32 state and token-shift carries;
        hymba's ``mamba.S``); they do not grow with tokens."""
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
