"""The decode megastep (``decode_steps > 1``) of the port's paged engine.

The megastep is a pure dispatch fusion of the per-tick decode loop —
position advance, EOS and ``max_new`` finish masking run on the device,
finished rows coast in the trash block — so each case holds the port's
megastep to the port's own per-tick engine on the CPU (where the window runs
eagerly): tokens identical and greedy margins equal bit for bit, through
slot recycling, mid-window EOS with early release, per-request EOS, the
recurrent arch, integer KV and reduced deepseek-v3's absorbed MLA kernel
path and MoE.  The reference's cases on prefix sharing and the speculative
engine are not here: neither is ported.

Against the JAX package: one module-scoped run of the reference's
``PagedServeEngine(decode_steps=4)`` on reduced yi-6b (bf16 and int8 KV),
rwkv6-7b and deepseek-v3 with ``mla_absorb`` (MLA + MoE: the router sees
every row, and the two engines batch the same requests alike), with the
same params loaded into the port, under
``parity_up_to_ties`` at eps 1e-4, and the reference's 0.05 on integer KV
(a last-bit difference flips a KV code, ``ROADMAP.md`` queue 3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.nn.attention as jattention
from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.models.lm import Runtime as JRuntime
from repro.models.lm import init_lm as jinit_lm
from repro.nn.module import unbox
from repro.serve.engine import PagedServeEngine as JPagedServeEngine

from repro_torch.configs import get_arch, reduced
from repro_torch.convert import from_jax_numpy
from repro_torch.models.lm import Runtime, init_lm
from repro_torch.nn.attention import _paged_write
from repro_torch.serve.engine import PagedServeEngine, Request, deploy_params, parity_up_to_ties

torch.set_num_threads(1)

KW = dict(batch=2, max_seq=64, block_size=4, prefill_chunk=4, device="cpu")
EPS, KV_EPS = 1e-4, 0.05


def _arch(name):
    return reduced(get_arch(name))


_PARAMS = {}


def _params(name, deployed=False):
    """The port's own init (seed 0) of a reduced arch, A2Q float or deployed."""
    key = (name, deployed)
    if key not in _PARAMS:
        arch = _arch(name)
        p = init_lm(torch.Generator().manual_seed(0), arch, device="cpu")
        _PARAMS[key] = deploy_params(p, arch.quant) if deployed else p
    return _PARAMS[key]


def _prompts(vocab, seed=0, lens=(5, 3, 9, 2)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (n,)).astype(np.int32) for n in lens]


def _serve(name, prompts, max_new, deployed=False, **kw):
    e = PagedServeEngine(_arch(name), _params(name, deployed), **KW, **kw)
    return e, e.generate(prompts, max_new=max_new)


def _assert_same(tick, mega):
    """Tokens identical and greedy margins equal bit for bit, request by
    request, and every block back on the free list."""
    assert [r.generated for r in mega.last_requests] == [r.generated for r in tick.last_requests]
    assert [r.margins for r in mega.last_requests] == [r.margins for r in tick.last_requests]
    assert mega.cache.free_blocks == mega.cache.num_blocks - 1


@pytest.mark.parametrize("steps", [2, 4, 8])
def test_megastep_matches_per_tick_paged(steps):
    """Mixed prompt lengths, more requests than slots (slot recycling between
    windows), max_new=5 a multiple of no window, so the drain tail runs
    partly active windows; one decode dispatch a window."""
    prompts = _prompts(_arch("yi-6b").vocab)
    tick, _ = _serve("yi-6b", prompts, 5)
    mega, _ = _serve("yi-6b", prompts, 5, decode_steps=steps)
    _assert_same(tick, mega)
    tp = mega.throughput()
    assert 0 < tp["dispatches_per_token"] < 1
    assert mega.stats["decode_tokens"] == tick.stats["decode_tokens"]
    assert mega.stats["decode_dispatches"] < tick.stats["decode_dispatches"]
    assert mega.stats["graph_replays"] == 0  # the CPU runs every window eagerly


def test_megastep_eos_mid_window_parity_and_early_release():
    """A row whose EOS lands mid window stops exactly where the per-tick path
    stops (its later in-window samples are masked, never recorded) and
    releases its slot and blocks at the window's replay, not at max_new."""
    prompts = _prompts(_arch("yi-6b").vocab, seed=1, lens=(5, 7, 4))
    _, full = _serve("yi-6b", prompts, 6)
    eos = full[0][2]  # request 0 provably emits this mid-stream (greedy)
    tick, want = _serve("yi-6b", prompts, 6, eos_id=eos)
    mega, got = _serve("yi-6b", prompts, 6, eos_id=eos, decode_steps=8)
    _assert_same(tick, mega)
    assert got[0] == full[0][: full[0].index(eos) + 1]
    assert any(len(o) < 6 for o in got)  # early termination really happened


def test_megastep_recurrent_arch_matches_per_tick():
    """rwkv6's recurrent leaves are not block-paged, so coasting rows advance
    garbage state, harmless (finished rows are never read, ``reset_slot``
    zeroes a slot on admission); the live rows match the per-tick path."""
    prompts = _prompts(_arch("rwkv6-7b").vocab, seed=3, lens=(5, 3, 7))
    tick, _ = _serve("rwkv6-7b", prompts, 5)
    mega, _ = _serve("rwkv6-7b", prompts, 5, decode_steps=4)
    _assert_same(tick, mega)


def test_megastep_dispatch_accounting_exact():
    """One request, max_new=9, N=4: the first token is booked under prefill,
    the remaining 8 decode tokens fit exactly two fused windows."""
    mega, out = _serve("yi-6b", [np.arange(6, dtype=np.int32)], 9, decode_steps=4)
    assert len(out[0]) == 9
    assert mega.stats["decode_tokens"] == 8
    assert mega.stats["decode_dispatches"] == 2
    assert mega.throughput()["dispatches_per_token"] == 0.25


@pytest.mark.parametrize("kv_bits", [8, 4])
def test_megastep_integer_kv_matches_per_tick(kv_bits):
    """The window reads and writes the same integer block pools the per-tick
    engine does (codes quantized on write, read through the decode kernel's
    plain version): identical codes in, identical tokens and margins out."""
    prompts = _prompts(_arch("yi-6b").vocab, seed=5, lens=(6, 4, 5))
    kw = dict(kv_quant=True, kv_bits=kv_bits, deployed=True,
              rt=Runtime(int_forward=True, decode_kernel=True))
    tick, _ = _serve("yi-6b", prompts, 5, **kw)
    mega, _ = _serve("yi-6b", prompts, 5, decode_steps=4, **kw)
    _assert_same(tick, mega)


def test_megastep_per_request_eos_override():
    """A per-request eos_id beats the engine default inside the device mask
    (the eos input is per row, not a scalar); -1 never fires."""
    prompts = _prompts(_arch("yi-6b").vocab, seed=6, lens=(5, 5))
    _, full = _serve("yi-6b", prompts, 6)
    eos0 = full[0][1]
    mega = PagedServeEngine(_arch("yi-6b"), _params("yi-6b"), decode_steps=8, eos_id=full[1][0],
                            **KW)
    reqs = [Request(uid=0, prompt=prompts[0], max_new=6, eos_id=eos0),
            Request(uid=1, prompt=prompts[1], max_new=6, eos_id=-1)]  # never fires
    for r in reqs:
        mega.submit(r)
    while not mega.sched.idle():
        mega.step()
    assert reqs[0].generated == full[0][: full[0].index(eos0) + 1]
    assert reqs[1].generated == full[1]


def test_megastep_smollm_int_chain_int8_kv_matches_per_tick():
    """Reduced smollm-135m on ``--int-chain --kv-int8 --decode-kernel`` (the
    card's phase 4m path), more requests than slots and an EOS mid window."""
    prompts = _prompts(_arch("smollm-135m").vocab, seed=7, lens=(5, 8, 3, 6))
    kw = dict(kv_quant=True, deployed=True, rt=Runtime(int_chain=True, decode_kernel=True))
    _, full = _serve("smollm-135m", prompts, 7, **kw)
    eos = full[1][3]
    tick, _ = _serve("smollm-135m", prompts, 7, eos_id=eos, **kw)
    mega, got = _serve("smollm-135m", prompts, 7, eos_id=eos, decode_steps=4, **kw)
    _assert_same(tick, mega)
    assert len(got[1]) == full[1].index(eos) + 1


def test_megastep_deepseek_absorbed_kernel_matches_per_tick():
    """Reduced deepseek-v3, deployed, with ``mla_absorb=True`` and
    ``decode_kernel=True``: the MLA latent kernel's plain version and the MoE
    layer's static expert-slot form inside the window.  The router sees
    every row, finished ones too (capacity drops depend on the whole
    batch), so a row that ends mid window must ride the rest of it as the
    per-tick path's dead rows do, token 0 at position 0: request 0's EOS
    mid window makes that visible in request 1's margins.  (With more
    requests than slots the two paths batch differently — the per-tick path
    admits into a freed slot at the next tick, the megastep at the next
    window — so a MoE model's later rows are routed among other rows, in the
    reference too.)"""
    prompts = _prompts(_arch("deepseek-v3-671b").vocab, seed=8, lens=(5, 7))
    rt = Runtime(int_forward=True, decode_kernel=True, mla_absorb=True)
    _, full = _serve("deepseek-v3-671b", prompts, 9, deployed=True, rt=rt)
    eos = full[0][2]
    tick, _ = _serve("deepseek-v3-671b", prompts, 9, deployed=True, rt=rt, eos_id=eos)
    mega, got = _serve("deepseek-v3-671b", prompts, 9, deployed=True, rt=rt, eos_id=eos,
                       decode_steps=8)
    _assert_same(tick, mega)
    assert len(got[0]) < 9 and len(got[1]) > len(got[0])


def test_decode_steps_below_one_is_refused():
    with pytest.raises(ValueError, match="decode_steps must be >= 1"):
        PagedServeEngine(_arch("yi-6b"), _params("yi-6b"), decode_steps=0, **KW)


# -- against the JAX package -------------------------------------------------

JAX_CASES = {"yi-6b": dict(), "yi-6b int8 KV": dict(kv_quant=True), "rwkv6-7b": dict(),
             # MLA + MoE: the router sees every row, and both engines batch alike
             "deepseek-v3-671b absorbed": dict(mla_absorb=True)}
JAX_KW = dict(batch=2, max_seq=64, block_size=4, prefill_chunk=4)


@pytest.fixture(scope="module")
def jax_megastep():
    """Per case: the JAX init's params as numpy and the reference megastep
    engine's driven requests (tokens + margins)."""
    out = {}
    for case, kw in JAX_CASES.items():
        name = case.split()[0]
        arch = jreduced(jget_arch(name))
        params = unbox(jinit_lm(jax.random.PRNGKey(0), arch))
        kw = {k: v for k, v in kw.items() if k != "mla_absorb"}
        if JAX_CASES[case].get("mla_absorb"):
            kw["rt"] = JRuntime(mla_absorb=True)
        e = JPagedServeEngine(arch, params, decode_steps=4, **JAX_KW, **kw)
        e.generate(_prompts(arch.vocab, seed=9), max_new=5)
        out[case] = (jax.tree.map(np.asarray, params), e.last_requests)
    return out


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_megastep_matches_jax_megastep(jax_megastep, case):
    params_np, ref_reqs = jax_megastep[case]
    name = case.split()[0]
    arch = _arch(name)
    kw = {k: v for k, v in JAX_CASES[case].items() if k != "mla_absorb"}
    if JAX_CASES[case].get("mla_absorb"):
        kw["rt"] = Runtime(mla_absorb=True)
    e = PagedServeEngine(arch, from_jax_numpy(params_np), decode_steps=4, **KW, **kw)
    outs = e.generate(_prompts(arch.vocab, seed=9), max_new=5)
    eps = KV_EPS if JAX_CASES[case].get("kv_quant") else EPS
    ok, ties, detail = parity_up_to_ties(ref_reqs, outs, eps)
    assert ok, detail
    assert sum(a.generated == b for a, b in zip(ref_reqs, outs)) >= len(outs) - ties
    assert e.stats["decode_dispatches"] == 2  # 4 requests over 2 slots, 4 decode ticks each


def test_paged_write_past_the_table_matches_the_reference_drop():
    """A position whose block index falls past the table: the reference drops
    the write (``mode="drop"``), the port sends it to slot 0 of the trash
    block.  Every other block must equal the reference's pool."""
    rng = np.random.default_rng(12)
    NB, bs, MB = 6, 4, 2
    pool = rng.normal(size=(NB, bs, 3)).astype(np.float32)
    bt = np.array([[1, 3], [2, 0]], np.int32)  # row 1 owns one block
    pos = np.array([[6, 7, 8], [1, 4, 9]], np.int32)  # 8 and 9 are past the table
    val = rng.normal(size=(2, 3, 3)).astype(np.float32)
    want = np.asarray(jattention._paged_write(jnp.asarray(pool), jnp.asarray(val),
                                              jnp.asarray(bt), jnp.asarray(pos)))
    got = _paged_write(torch.from_numpy(pool.copy()), torch.from_numpy(val),
                       torch.from_numpy(bt), torch.from_numpy(pos)).numpy()
    np.testing.assert_array_equal(got[1:], want[1:])
    assert not np.array_equal(want[[1, 2, 3]], pool[[1, 2, 3]])  # the kept writes landed
