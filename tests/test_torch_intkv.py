"""Integer KV pools (int8 codes, packed int4) in the port against the JAX package.

Covered:

* the write side: ``_kv_quantize`` (codes and scales), the nibble pack and
  unpack, ``_paged_write_q8`` and ``_paged_gather_deq`` on the same seeded
  fp32 inputs as ``repro.nn.attention``'s — codes and scales exactly;
* the read side: ``ops.paged_attention`` on int8 and packed-int4 pools (on
  the CPU: the plain version) against the JAX package's jnp oracles
  ``ref_paged_attention_q8``/``_q4``, with trash entries, a zero-length row
  and a sliding window, and ``ops.paged_mla_attention`` on quantized latent
  pools written by ``_paged_write_q8`` against ``ref_paged_mla_attention``;
* the slice as a whole: reduced yi-6b (GQA) and reduced deepseek-v3 (MLA,
  ``mla_absorb=True``) deployed to int8 and served with ``kv_quant`` at 8 and
  4 bits, ``Runtime(int_chain=True, decode_kernel=True)`` in the port against
  the JAX engine with ``Runtime(int_chain=True)`` on its gathered
  dequantized view (the jnp path, not the Pallas attention interpreter), one
  reference run per configuration for the file; the port's kernel read
  against its own gathered view; and a counter showing that with
  ``mla_absorb`` the int-pool MLA op runs once per layer per single-token
  forward.

Tolerances: codes, scales and packed bytes exactly; the attention ops 1e-5
(the same fp32 dequant and softmax summed in another order).  Engine tokens,
port against JAX, under ``parity_up_to_ties`` at the reference's own
quantization-noise eps for integer KV, 0.05 (``tests/test_paged.py``'s
int8-KV parity gate), with its non-vacuity check (every request that met no
tie decodes identically), and margins are not compared: an rmsnorm output
one ulp apart between the frameworks flips an act-quant code at a rounding
tie (on these prompts one code of one token in layer 0, moving that token's
K by one activation quantum); with float KV the next act-quant absorbs it,
but integer KV re-quantizes the token against a new absmax scale, which
moves whole KV quanta (1/127 or 1/7 of the token's absmax) and cascades
into later layers' codes — the same quantization noise that eps bounds.
The port's two reads of its own pools (kernel op, gathered view) agree
token for token and to 1e-4 in margin.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.kernels import ref as jref
from repro.models.lm import Runtime as JRuntime
from repro.models.lm import init_lm as jinit_lm
from repro.nn import attention as jattn
from repro.nn.module import unbox
from repro.serve.engine import PagedServeEngine as JPagedServeEngine
from repro.serve.engine import deploy_params as jdeploy_params

from repro_torch.configs import get_arch, reduced
from repro_torch.convert import from_jax_numpy
from repro_torch.kernels import ops
from repro_torch.models.lm import Runtime
from repro_torch.nn import attention as tattn
from repro_torch.serve.engine import PagedServeEngine, parity_up_to_ties

torch.set_num_threads(1)

ENGINE = dict(batch=2, max_seq=32, block_size=4, prefill_chunk=4)
MAX_NEW = 5
EPS = 1e-4
KV_EPS = 0.05  # the reference's quantization-noise eps for integer KV


def _update(rng, shape):
    """A K/V update with magnitudes spread over decades and an all-zero
    token (its scale is the ``tiny`` floor)."""
    v = rng.normal(size=shape) * np.exp(rng.uniform(-3, 3, shape[:-1] + (1,)))
    v = v.astype(np.float32)
    v[0, 0] = 0.0
    return v


# ---------------------------------------------------------------------------
# The write side
# ---------------------------------------------------------------------------


def _assert_scales_equal(got: np.ndarray, want: np.ndarray, bits: int):
    """Scales bit for bit, except an all-zero token's: its scale is the floor
    ``tiny / qmax``, a subnormal that XLA on the CPU flushes to 0 and
    PyTorch keeps.  Either way its codes are 0 and it dequantizes to 0."""
    floor = np.finfo(np.float32).tiny / ((1 << (bits - 1)) - 1)
    sub = want < np.finfo(np.float32).tiny
    np.testing.assert_array_equal(got[~sub], want[~sub])
    assert (got[sub] <= floor).all() and (want[sub] == 0).all()


@pytest.mark.parametrize("bits", [8, 4])
def test_kv_quantize_codes_and_scales_match_jax(bits):
    val = _update(np.random.default_rng(bits), (3, 5, 2, 64))
    jc, js = jattn._kv_quantize(jnp.asarray(val), bits=bits)
    tc, ts = tattn._kv_quantize(torch.from_numpy(val), bits=bits)
    assert tc.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    _assert_scales_equal(ts.numpy(), np.asarray(js), bits)
    qmax = (1 << (bits - 1)) - 1
    assert np.abs(tc.numpy()).max() == qmax and (tc.numpy()[0, 0] == 0).all()


def test_nibble_pack_and_unpack_match_jax():
    codes = np.random.default_rng(3).integers(-8, 8, (4, 3, 32)).astype(np.int8)
    packed = tattn._pack_nibbles(torch.from_numpy(codes))
    assert packed.dtype == torch.uint8 and packed.shape == (4, 3, 16)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jattn._pack_nibbles(jnp.asarray(codes))))
    unpacked = tattn._unpack_nibbles(packed)
    np.testing.assert_array_equal(unpacked.numpy(),
                                  np.asarray(jattn._unpack_nibbles(jnp.asarray(packed.numpy()))))
    np.testing.assert_array_equal(unpacked.numpy(), codes)  # a lossless round trip


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("layout", ["gqa", "mla"])
def test_paged_write_q8_and_gather_deq_match_jax(bits, layout):
    """Quantize-on-write through a block table (row 1 ends in a trash entry,
    a position past the table goes to the trash block, where the reference
    drops it), then the dequantized gathered view: pools, scale pools and the
    view exactly, everywhere but the trash block 0 (never read as valid)."""
    rng = np.random.default_rng(10 + bits)
    NB, bs, KV, D = 8, 4, 2, 16
    heads = (KV,) if layout == "gqa" else ()
    width = D // 2 if bits == 4 else D
    pool = np.zeros((NB, bs) + heads + (width,), np.uint8 if bits == 4 else np.int8)
    scales = np.zeros((NB, bs) + heads, np.float32)
    bt = np.array([[1, 2, 3], [4, 5, 0]], np.int32)
    pos = np.array([[2, 3, 4, 5, 6], [5, 6, 7, 8, 12]], np.int32)  # 12 // 4 = 3: past the table
    val = _update(rng, (2, 5) + heads + (D,))
    jp, js = jattn._paged_write_q8(jnp.asarray(pool), jnp.asarray(scales), jnp.asarray(val),
                                   jnp.asarray(bt), jnp.asarray(pos))
    tp, ts = tattn._paged_write_q8(torch.from_numpy(pool.copy()), torch.from_numpy(scales.copy()),
                                   torch.from_numpy(val), torch.from_numpy(bt),
                                   torch.from_numpy(pos))
    np.testing.assert_array_equal(tp.numpy()[1:], np.asarray(jp)[1:])
    _assert_scales_equal(ts.numpy()[1:], np.asarray(js)[1:], bits)
    # ten tokens written, the one past the table dropped (or sent to the trash
    # block, where row 1's trash entry writes too); outside the trash block
    # eight tokens, one of them all zeros (scale 0 in JAX, subnormal here)
    assert (np.asarray(js)[1:] != 0).sum() == 7 * (KV if layout == "gqa" else 1)
    assert (ts.numpy()[1:] != 0).sum() == 8 * (KV if layout == "gqa" else 1)
    got = tattn._paged_gather_deq(tp, ts, torch.from_numpy(bt)).numpy()
    want = np.asarray(jattn._paged_gather_deq(jp, js, jnp.asarray(bt)))
    real = np.repeat(bt != 0, bs, axis=1)  # the gathered positions outside the trash block
    np.testing.assert_array_equal(got[real], want[real])


# ---------------------------------------------------------------------------
# The read side: the kernel ops' plain versions against the jnp oracles
# ---------------------------------------------------------------------------


def _int_pool_case(bits, B=5, H=8, KV=2, Dh=16, NB=12, bs=4):
    rng = np.random.default_rng(20 + bits)
    q = rng.normal(size=(B, H, Dh)).astype(np.float32)
    lim = 128 if bits == 8 else 8
    kp = rng.integers(-lim + 1, lim, (NB, bs, KV, Dh)).astype(np.int8)
    vp = rng.integers(-lim + 1, lim, (NB, bs, KV, Dh)).astype(np.int8)
    if bits == 4:
        kp, vp = (tattn._pack_nibbles(torch.from_numpy(p)).numpy() for p in (kp, vp))
    kps = rng.uniform(0.005, 0.05, (NB, bs, KV)).astype(np.float32)
    vps = rng.uniform(0.005, 0.05, (NB, bs, KV)).astype(np.float32)
    # row 0 full, row 1 ragged, row 2 empty, rows 3-4 end in trash entries
    bt = np.asarray([[1, 2, 3], [4, 5, 6], [0, 0, 0], [7, 8, 0], [9, 0, 0]], np.int32)[:B]
    lengths = np.asarray([12, 9, 0, 5, 1], np.int32)[:B]
    return q, kp, vp, kps, vps, bt, lengths


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("window", [None, 3])
def test_paged_attention_int_pools_match_jnp_oracle(bits, window):
    q, kp, vp, kps, vps, bt, lengths = _int_pool_case(bits)
    oracle = jref.ref_paged_attention_q8 if bits == 8 else jref.ref_paged_attention_q4
    want = oracle(*(jnp.asarray(a) for a in (q, kp, vp, kps, vps, bt, lengths)), window=window)
    t = [torch.from_numpy(a) for a in (q, kp, vp, bt, lengths)]
    got = ops.paged_attention(*t, kps=torch.from_numpy(kps), vps=torch.from_numpy(vps),
                              window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert np.isfinite(got.numpy()).all() and (got.numpy()[2] == 0).all()
    # the value scales are load-bearing: doubling them doubles the output
    twice = ops.paged_attention(*t, kps=torch.from_numpy(kps), vps=torch.from_numpy(2 * vps),
                                window=window)
    np.testing.assert_allclose(twice.numpy(), 2 * got.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("bits", [8, 4])
def test_paged_attention_int_pools_ignore_entries_past_the_length(bits):
    q, kp, vp, kps, vps, bt, lengths = _int_pool_case(bits)
    args = lambda table: [torch.from_numpy(a) for a in (q, kp, vp, table, lengths)]
    sc = dict(kps=torch.from_numpy(kps), vps=torch.from_numpy(vps))
    base = ops.paged_attention(*args(bt), **sc)
    redirected = bt.copy()
    redirected[3, 2] = redirected[4, 1] = 11  # live-looking blocks past rows 3 and 4
    np.testing.assert_array_equal(ops.paged_attention(*args(redirected), **sc).numpy(),
                                  base.numpy())


def test_paged_attention_int_pool_argument_checks():
    q, kp, vp, kps, vps, bt, lengths = (torch.from_numpy(a) for a in _int_pool_case(4))
    with pytest.raises(ValueError):  # scale pools pair
        ops.paged_attention(q, kp, vp, bt, lengths, kps=kps)
    with pytest.raises(ValueError):  # packed int4 needs its scale pools
        ops.paged_attention(q, kp, vp, bt, lengths)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("act_quant", [False, True], ids=["plain", "act_quant"])
def test_paged_mla_attention_on_written_int_pools_matches_jnp_oracle(bits, act_quant):
    """Latent pools filled by the port's ``_paged_write_q8`` (int8, packed
    int4), read by ``ops.paged_mla_attention`` against the JAX oracle on the
    same pools."""
    rng = np.random.default_rng(30 + bits)
    B, H, R, P, NB, bs = 3, 8, 32, 16, 10, 4
    lens = [7, 0, 12]
    bt = np.array([[1, 2, 0], [0, 0, 0], [3, 4, 5]], np.int32)
    code = torch.uint8 if bits == 4 else torch.int8
    ckvp = torch.zeros((NB, bs, R // (8 // bits)), dtype=code)
    kpep = torch.zeros((NB, bs, P // (8 // bits)), dtype=code)
    ckvs, kpes = torch.zeros((NB, bs)), torch.zeros((NB, bs))
    pos = torch.from_numpy(np.broadcast_to(np.arange(12, dtype=np.int32), (B, 12)).copy())
    tattn._paged_write_q8(ckvp, ckvs, torch.from_numpy(_update(rng, (B, 12, R))),
                          torch.from_numpy(bt), pos)
    tattn._paged_write_q8(kpep, kpes, torch.from_numpy(_update(rng, (B, 12, P))),
                          torch.from_numpy(bt), pos)
    q_lat = rng.normal(size=(B, H, R)).astype(np.float32)
    q_pe = rng.normal(size=(B, H, P)).astype(np.float32)
    extra = dict(aq_scale=np.float32(0.05), act_bits=8) if act_quant else {}
    lengths = np.asarray(lens, np.int32)
    got = ops.paged_mla_attention(torch.from_numpy(q_lat), torch.from_numpy(q_pe), ckvp, kpep,
                                  torch.from_numpy(bt), torch.from_numpy(lengths), ckvs=ckvs,
                                  kpes=kpes, scale=0.125,
                                  **{k: (torch.tensor(v) if k == "aq_scale" else v)
                                     for k, v in extra.items()})
    want = jref.ref_paged_mla_attention(
        *(jnp.asarray(a) for a in (q_lat, q_pe, ckvp.numpy(), kpep.numpy(), bt, lengths,
                                   ckvs.numpy(), kpes.numpy())),
        scale=0.125, **{k: (jnp.asarray(v) if k == "aq_scale" else v) for k, v in extra.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    assert (got.numpy()[1] == 0).all()


# ---------------------------------------------------------------------------
# The slice as a whole: the engines with integer KV
# ---------------------------------------------------------------------------

CONFIGS = [("yi-6b", 8), ("yi-6b", 4), ("deepseek-v3-671b", 8), ("deepseek-v3-671b", 4)]


def _prompts(vocab):
    rng = np.random.default_rng(17)
    return [rng.integers(0, vocab, (n,)).astype(np.int32) for n in (5, 9, 4)]


@pytest.fixture(scope="module")
def deployed():
    """Per arch: the JAX init deployed to int8, as numpy."""
    out = {}
    for name in ("yi-6b", "deepseek-v3-671b"):
        arch = jreduced(jget_arch(name))
        params = jax.jit(lambda k: jdeploy_params(unbox(jinit_lm(k, arch)), arch.quant))(
            jax.random.PRNGKey(0))
        out[name] = jax.tree.map(np.asarray, params)
    return out


@pytest.fixture(scope="module")
def reference(deployed):
    """Per (arch, kv_bits): the JAX engine's driven requests with integer KV,
    int-chain, its gathered dequantized read (and ``mla_absorb`` for MLA)."""
    out = {}
    for name, bits in CONFIGS:
        arch = jreduced(jget_arch(name))
        rt = JRuntime(int_chain=True, mla_absorb=name.startswith("deepseek"))
        e = JPagedServeEngine(arch, jax.tree.map(jnp.asarray, deployed[name]), **ENGINE, rt=rt,
                              kv_quant=True, kv_bits=bits)
        e.generate(_prompts(arch.vocab), max_new=MAX_NEW)
        out[name, bits] = e.last_requests
    return out


def _port_engine(name, params_np, bits, **rt):
    arch = reduced(get_arch(name))
    rt.setdefault("mla_absorb", name.startswith("deepseek"))
    return PagedServeEngine(arch, from_jax_numpy(params_np), device="cpu", kv_quant=True,
                            kv_bits=bits, rt=Runtime(int_chain=True, **rt), **ENGINE)


@pytest.fixture
def kernel_calls(monkeypatch):
    """Counts calls of the two paged-attention ops with integer pools (the
    layers look the ops up on the module at call time)."""
    calls = {"paged_attention": 0, "paged_mla_attention": 0}
    for op in calls:
        real = getattr(ops, op)

        def counted(*args, _real=real, _op=op, **kw):
            pools = args[2]
            assert pools.dtype in (torch.int8, torch.uint8)
            assert kw.get("kps", kw.get("ckvs")) is not None
            calls[_op] += 1
            return _real(*args, **kw)

        monkeypatch.setattr(ops, op, counted)
    return calls


@pytest.mark.parametrize("name,bits", CONFIGS, ids=[f"{n.split('-')[0]}-int{b}" for n, b in CONFIGS])
def test_int_kv_engine_matches_jax_engine(deployed, reference, kernel_calls, name, bits):
    ref_reqs = reference[name, bits]
    arch = reduced(get_arch(name))
    e = _port_engine(name, deployed[name], bits, decode_kernel=True)
    assert {v.dtype for v in e.cache.pools["0"]["attn"].values()} == \
        {torch.int8 if bits == 8 else torch.uint8, torch.float32}
    outs = e.generate(_prompts(arch.vocab), max_new=MAX_NEW)
    ok, ties, detail = parity_up_to_ties(ref_reqs, outs, KV_EPS)
    assert ok, detail
    assert sum(r.generated == o for r, o in zip(ref_reqs, outs)) >= len(outs) - ties
    assert all(len(req.generated) == MAX_NEW for req in e.last_requests)
    # every single-token forward of every layer read the integer pools
    # through the kernel op: the decode ticks, and a last prefill chunk of
    # one token
    ticks = e.throughput()["decode_dispatches"]
    ones = sum(len(p) % ENGINE["prefill_chunk"] == 1 for p in _prompts(arch.vocab))
    n_layers = sum(s.count for s in arch.stacks)
    op = "paged_mla_attention" if name.startswith("deepseek") else "paged_attention"
    assert ticks > 0 and kernel_calls[op] == n_layers * (ticks + ones)
    assert e.throughput()["int_chain_requant_dispatches"] == 0


@pytest.mark.parametrize("name,bits", CONFIGS, ids=[f"{n.split('-')[0]}-int{b}" for n, b in CONFIGS])
def test_int_kv_kernel_read_matches_gathered_view(deployed, name, bits):
    """The port's own two reads of the same integer pools — the kernel op and
    the dequantized gathered view — give the same tokens."""
    arch = reduced(get_arch(name))
    runs = []
    for kernel in (True, False):
        e = _port_engine(name, deployed[name], bits, decode_kernel=kernel)
        runs.append((e.generate(_prompts(arch.vocab), max_new=MAX_NEW), e.last_requests))
    ok, ties, detail = parity_up_to_ties(runs[1][1], runs[0][0], EPS)
    assert ok and ties == 0, detail
    for a, b in zip(runs[0][1], runs[1][1]):
        np.testing.assert_allclose(a.margins, b.margins, rtol=0, atol=EPS)


def test_mla_int_pools_reach_the_kernel_only_when_absorbed(deployed, kernel_calls):
    """The reference's MLA int-pool kernel test never sets ``mla_absorb``, so
    it never reaches the kernel; here the absorbed decode does, and the
    materialized one does not."""
    name = "deepseek-v3-671b"
    arch = reduced(get_arch(name))
    prompt = _prompts(arch.vocab)[:1]  # 5 tokens: chunks of 4 and 1
    _port_engine(name, deployed[name], 8, decode_kernel=True,
                 mla_absorb=False).generate(prompt, max_new=3)
    assert kernel_calls["paged_mla_attention"] == 0
    e = _port_engine(name, deployed[name], 8, decode_kernel=True)
    e.generate(prompt, max_new=3)
    ticks = e.throughput()["decode_dispatches"]
    assert kernel_calls["paged_mla_attention"] == sum(s.count for s in arch.stacks) * (ticks + 1)


def test_kv_bytes_per_token_and_bits_check():
    """int8 codes and one fp32 scale a slot and KV head: at Dh=64 a GQA
    token costs (64 + 4) / (2 * 64) of its bf16 bytes, int4 (32 + 4) / 128;
    kv_bits other than 8 or 4 is refused."""
    arch = get_arch("smollm-135m")
    kw = dict(block_size=16, max_seq=32, device="cpu")
    from repro_torch.serve.paged_cache import PagedKVCache

    per = {b: PagedKVCache(arch, 1, kv_quant=b != 16, kv_bits=b if b != 16 else 8,
                           **kw).kv_bytes_per_token() for b in (16, 8, 4)}
    layer_kv = arch.n_layers * 3 * 2  # layers x KV heads x (K, V)
    assert per == {16: layer_kv * 64 * 2, 8: layer_kv * (64 + 4), 4: layer_kv * (32 + 4)}
    with pytest.raises(ValueError):
        PagedKVCache(arch, 1, kv_quant=True, kv_bits=2, **kw)
