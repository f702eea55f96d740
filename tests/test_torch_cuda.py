"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: each test skips where no CUDA device is visible. On a GPU
machine run them with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The shapes cover what `chip_smoke.py`'s llama2-7b shapes do not: output
widths that are not a multiple of the 128-column strip (or of 4, which
takes scalar loads), batches of 1 to 64 rows (4 a block), ragged reduction
tails, grouped scales with bn at or below the group size, q = p = 8, and
every path of the split plan (`kernel.split_plan`): one block owning many
tiles, a workspace folded after splits of one tile, and splits of several
tiles, with a ragged last one too (`tests/test_torch_bitplane_plan.py`
checks that these shapes reach each). B2 through its member table (mixed
q/p and n, ragged M, grouped scales, llama2-7b's q/k/v and up/gate, at
B = 1, 4 and 64: one split and several) and through the slot-major entry,
bitwise; B5 at one split and several. For flash-decode, every head size
and cache type, GQA (down to one KV head; qwen2-7b's 7 and starcoder2-3b's
12 query heads a KV head at 4096 slots, at B = 4 and 1), windows, ragged
cache lengths, lanes with no valid slot and the JAX wrapper's padded slot
count, the kv8 path's stamps (16–31 valid of 4096 slots), and a fold
launch wherever the plan splits the cache; head dims between the built
sizes (16, 80, 100, 112), whose rows take whole 16-byte loads or, at 100
for bf16 and int8 caches, element-wide ones, and above the fast body (320,
1000: the generic body). B3 over a bf16 expert stack
(the tensor-core kernel) at qwen2-moe's decode-count and full-capacity
shapes, ragged M and N, R above 8 and above 16, and counts [0, 8, 3, 0].
"""
import pytest
import torch

from repro_torch.core.bitplane import make_bitplane_weights
from repro_torch.core.quant import (QuantSpec, quantize_activations,
                                    quantize_weights)
from repro_torch.kernels.bitplane_gemv import kernel, ops, program, ref
from repro_torch.kernels.decode_attention import kernel as dkernel
from repro_torch.kernels.decode_attention import ops as dops
from repro_torch.kernels.decode_attention import ref as dref
from repro_torch.kernels.quant_matmul import kernel as qkernel
from repro_torch.kernels.quant_matmul import ops as qops
from repro_torch.kernels.quant_matmul import ref as qref

pytestmark = pytest.mark.cuda

# (n, m, q, p, groups, B)
SHAPES = [(300, 90, 2, 4, 1, 3), (1000, 130, 3, 2, 1, 11),
          (512, 40, 5, 4, 2, 1), (4096, 200, 2, 4, 1, 17),
          (11008, 64, 2, 8, 1, 4),
          # llama2-7b's down (22 tiles, 8 live words in the last) and
          # lm_head at decode, lm_head at a 64-row prefill
          (11008, 4096, 2, 4, 1, 4), (4096, 32000, 2, 4, 1, 4),
          (4096, 32000, 2, 4, 1, 64),
          # splits of 7 tiles and a ragged last one; B = 1, 9 and 64
          (11008, 1408, 2, 4, 1, 64), (300, 40, 2, 4, 1, 1),
          (1000, 130, 3, 2, 1, 9), (1000, 40, 2, 3, 1, 64),
          # q = p = 8; grouped scales with bn = group size and below it
          (1024, 256, 8, 8, 1, 4), (2048, 130, 4, 4, 4, 9),
          (2048, 130, 2, 4, 16, 4), (640, 33, 1, 3, 5, 2),
          # one reduction tile
          (256, 100, 3, 4, 1, 5)]


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


def _leaf(gen, n, m, q, g):
    w = torch.randn((n, m), generator=gen, device="cuda")
    return make_bitplane_weights(
        w, QuantSpec(bits=q, group_size=n // g if g > 1 else -1))


def _folds(n, m, g, b) -> int:
    """Fold launches of one call: 1 when the plan splits the tiles."""
    bn, _ = ops._pick_blocks(n, m, None, None, n // g if g > 1 else None)
    _, splits = kernel.split_plan(-(-n // bn), m, b,
                                  kernel._sms(torch.device("cuda")))
    return int(splits > 1)


@pytest.mark.parametrize("n,m,q,p,g,b", SHAPES)
def test_gemv_bs_bitwise_equals_plain(gen, n, m, q, p, g, b):
    bw = _leaf(gen, n, m, q, g)
    x = torch.randn((b, n), generator=gen, device="cuda")
    k0 = dict(kernel.LAUNCHES)
    got = ops.bitplane_gemv_bitserial(x, bw, QuantSpec(bits=p))
    want = ops.bitplane_gemv_bitserial(x, bw, QuantSpec(bits=p),
                                       impl="reference")
    torch.cuda.synchronize()
    assert kernel.LAUNCHES["gemv_bs"] == k0["gemv_bs"] + 1
    assert kernel.LAUNCHES["gemv_bs_fold"] == \
        k0["gemv_bs_fold"] + _folds(n, m, g, b)
    assert torch.equal(got, want)


@pytest.mark.parametrize("n,m,q,p,g,b", SHAPES)
def test_gemv_f_within_tolerance(gen, n, m, q, p, g, b):
    bw = _leaf(gen, n, m, q, g)
    x = torch.randn((b, n), generator=gen, device="cuda")
    k0 = dict(kernel.LAUNCHES)
    got = ops.bitplane_gemv(x, bw)
    want = ops.bitplane_gemv(x, bw, impl="reference")
    torch.cuda.synchronize()
    assert kernel.LAUNCHES["gemv_f"] == k0["gemv_f"] + 1
    assert kernel.LAUNCHES["gemv_f_fold"] == \
        k0["gemv_f_fold"] + _folds(n, m, g, b)
    tol = 1e-5 * want.abs() + 1e-5 * float(want.abs().max())
    assert bool(((got - want).abs() <= tol).all())


@pytest.mark.parametrize("b", [1, 4, 9])
def test_program_gemv_bitwise_equals_plain_and_per_leaf(gen, b):
    ws = [_leaf(gen, 300, m, q, 1) for m, q in ((90, 2), (130, 3), (40, 4))]
    x = torch.randn((b, 300), generator=gen, device="cuda")
    c0 = dict(ref.CALLS)
    fused = program.fused_group_linears(x, ws, 4)
    assert ref.CALLS == c0                   # no plain version on the card
    spec = QuantSpec(bits=4)
    for f, w in zip(fused, ws):
        assert torch.equal(f, ops.bitplane_gemv_bitserial(x, w, spec))
        assert torch.equal(f, ops.bitplane_gemv_bitserial(
            x, w, spec, impl="reference"))


def test_wrappers_reject_bad_inputs(gen):
    bw = _leaf(gen, 256, 64, 2, 1)
    codes = torch.zeros((2, 256), dtype=torch.uint8, device="cuda")
    scales = torch.zeros((1, 64), device="cuda")
    with pytest.raises(ValueError, match="int32"):
        kernel.gemv_bs(codes, bw.planes.float(), scales, q=2, p=4, z_a=8,
                       z_w=2, bn=256)
    with pytest.raises(ValueError, match="bn"):
        kernel.gemv_bs(codes, bw.planes, scales, q=2, p=4, z_a=8, z_w=2,
                       bn=1024)
    with pytest.raises(ValueError, match="cpu"):
        kernel.gemv_bs(codes, bw.planes.cpu(), scales, q=2, p=4, z_a=8,
                       z_w=2, bn=256)


# (B, S, H, Hkv, D, window): ragged S, GQA down to one KV head, windows;
# qwen2-7b's GQA (7 query heads a KV head) at B = 4 and 1, starcoder2-3b's
# (12), each over several splits of the plan
DECODE_SHAPES = [(3, 1000, 8, 2, 128, None), (2, 77, 4, 4, 32, 16),
                 (1, 4096, 32, 32, 128, 1024), (4, 300, 8, 1, 256, None),
                 (2, 513, 8, 4, 64, 100), (4, 4096, 28, 4, 128, None),
                 (1, 4096, 28, 4, 128, None), (2, 2048, 24, 2, 128, None)]


def _decode_inputs(gen, b, s, h, hkv, d, q_dtype, kv):
    q = torch.randn((b, h, d), generator=gen, device="cuda").to(q_dtype)
    kf = torch.randn((b, s, hkv, d), generator=gen, device="cuda")
    vf = torch.randn((b, s, hkv, d), generator=gen, device="cuda")
    if kv == torch.int8:
        ks = kf.abs().amax(-1) / 127 + 1e-8
        vs = vf.abs().amax(-1) / 127 + 1e-8
        return (q, torch.round(kf / ks[..., None]).to(torch.int8),
                torch.round(vf / vs[..., None]).to(torch.int8), ks, vs)
    return q, kf.to(kv), vf.to(kv), None, None


@pytest.mark.parametrize("b,s,h,hkv,d,window", DECODE_SHAPES)
@pytest.mark.parametrize("q_dtype,kv", [
    (torch.float32, torch.float32), (torch.float32, torch.int8),
    (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.int8)])
def test_decode_attention_within_tolerance(gen, b, s, h, hkv, d, window,
                                           q_dtype, kv):
    """Against the plain version: rtol/atol 1e-5 for a float32 output, one
    bf16 ulp (plus 1e-5·max) for a bf16 one. Lane 0 sees a wrapped ring
    buffer, the last lane no valid slot (when B > 1)."""
    q, k, v, ks, vs = _decode_inputs(gen, b, s, h, hkv, d, q_dtype, kv)
    pos = torch.arange(b, device="cuda", dtype=torch.int32) * 7 + s // 2
    stamps = torch.arange(s, device="cuda", dtype=torch.int32).repeat(b, 1)
    pos[0] = 3 * s + 5       # slot t holds the newest position ≡ t mod s
    stamps[0] = pos[0] - (pos[0] - stamps[0]) % s
    if b > 1:
        stamps[-1] = -1
    l0 = dkernel.LAUNCHES["decode_attention"]
    f0 = dkernel.LAUNCHES["decode_attention_fold"]
    got = dops.decode_attention(pos, q, k, v, stamps, ks, vs, window=window)
    want = dops.decode_attention(pos, q, k, v, stamps, ks, vs,
                                 window=window, impl="reference")
    torch.cuda.synchronize()
    _, splits = dkernel.decode_plan(b, s, hkv,
                                    kernel._sms(torch.device("cuda")))
    assert dkernel.LAUNCHES["decode_attention"] == l0 + 1
    assert dkernel.LAUNCHES["decode_attention_fold"] == f0 + int(splits > 1)
    g, w = got.float(), want.float()
    assert bool(torch.isfinite(g).all())
    if q_dtype == torch.float32:
        tol = 1e-5 + 1e-5 * w.abs()
    else:
        tol = 2.0 ** -7 * torch.maximum(g.abs(), w.abs()) \
            + 1e-5 * float(w.abs().max())
    assert bool(((g - w).abs() <= tol).all()), float((g - w).abs().max())


@pytest.mark.parametrize("kv", [torch.float32, torch.int8])
def test_decode_attention_empty_lane_divides_by_padded_slots(gen, kv):
    """S = 1500 (padded to 2048 by the JAX wrapper's block of 1024): lane 1
    has no valid slot and gets Σ v / 2048, in the kernel as in the plain
    version (rtol/atol 1e-5)."""
    b, s, h, hkv, d = 2, 1500, 8, 4, 128
    q, k, v, ks, vs = _decode_inputs(gen, b, s, h, hkv, d, torch.float32, kv)
    pos = torch.tensor([1200, 700], device="cuda", dtype=torch.int32)
    stamps = torch.arange(s, device="cuda", dtype=torch.int32).repeat(b, 1)
    stamps[1] = -1
    got = dops.decode_attention(pos, q, k, v, stamps, ks, vs)
    want = dops.decode_attention(pos, q, k, v, stamps, ks, vs,
                                 impl="reference")
    torch.cuda.synchronize()
    assert dref.padded_slots(s) == 2048
    assert bool(((got - want).abs() <= 1e-5 + 1e-5 * want.abs()).all())
    vf = v.float() * (1.0 if vs is None else vs[..., None])
    mean = vf[1].sum(0).repeat_interleave(h // hkv, 0) / 2048
    assert torch.allclose(got[1], mean, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_on_the_paths_stamps(gen, q_dtype):
    """The kv8 slice's call: an int8 cache of 4096 slots of which only the
    first 16–31 are stamped (one prefill of 16 tokens and up to 15 decode
    steps), llama2-7b's 32 heads of 128 at B = 4: one split holds every
    valid slot, the others none, and the fold merges them."""
    b, s, h, d = 4, 4096, 32, 128
    q, k, v, ks, vs = _decode_inputs(gen, b, s, h, h, d, q_dtype,
                                     torch.int8)
    pos = torch.tensor([15, 20, 26, 30], device="cuda", dtype=torch.int32)
    t = torch.arange(s, device="cuda", dtype=torch.int32).repeat(b, 1)
    stamps = torch.where(t <= pos[:, None], t, torch.full_like(t, -1))
    f0 = dkernel.LAUNCHES["decode_attention_fold"]
    got = dops.decode_attention(pos, q, k, v, stamps, ks, vs)
    want = dops.decode_attention(pos, q, k, v, stamps, ks, vs,
                                 impl="reference")
    torch.cuda.synchronize()
    assert dkernel.LAUNCHES["decode_attention_fold"] == f0 + 1
    g, w = got.float(), want.float()
    if q_dtype == torch.float32:
        tol = 1e-5 + 1e-5 * w.abs()
    else:
        tol = 2.0 ** -7 * torch.maximum(g.abs(), w.abs()) \
            + 1e-5 * float(w.abs().max())
    assert bool(((g - w).abs() <= tol).all()), float((g - w).abs().max())


def test_decode_attention_rejects_bad_inputs(gen):
    q, k, v, _, _ = _decode_inputs(gen, 1, 64, 4, 4, 32, torch.float32,
                                   torch.float32)
    pos = torch.zeros(1, dtype=torch.int32, device="cuda")
    st = torch.arange(64, dtype=torch.int32, device="cuda")[None]
    # every head dim runs: 16 (a tiny config's) on the fast body, 320 on
    # the generic one, each against the plain version
    for d in (16, 320):
        qd, kd, vd, _, _ = _decode_inputs(gen, 1, 64, 4, 4, d,
                                          torch.float32, torch.float32)
        got = dkernel.decode_attention(pos, qd, kd, vd, st, None, None,
                                       scale=d ** -0.5, window=None)
        want = dref.decode_attention_ref(pos, qd, kd, vd, st, None, None,
                                         scale=d ** -0.5, window=None)
        torch.cuda.synchronize()
        assert got.shape == (1, 4, d)
        assert bool(((got - want).abs() <= 1e-5 + 1e-5 * want.abs()).all())
    with pytest.raises(ValueError, match="contiguous"):
        dkernel.decode_attention(pos, q, k.transpose(1, 2).contiguous()
                                 .transpose(1, 2), v, st, None, None,
                                 scale=1.0, window=None)
    with pytest.raises(ValueError, match="kv_positions"):
        dkernel.decode_attention(pos, q, k, v, st.long(), None, None,
                                 scale=1.0, window=None)


# (n, m, B, q, group_size): ragged n and m, B over one 8-row group
QMM_SHAPES = [(300, 90, 3, 2, -1), (1000, 130, 11, 4, -1),
              (512, 40, 1, 8, 128), (4096, 200, 17, 2, -1),
              (11008, 64, 4, 2, -1), (640, 33, 2, 1, 320),
              (4096, 4096, 4, 2, 128)]


@pytest.mark.parametrize("n,m,b,q,gs", QMM_SHAPES)
def test_quant_matmul_within_tolerance(gen, n, m, b, q, gs):
    """Against the plain version at rtol 1e-5, atol 1e-5·max|plain| (both
    sum in f32, in another order); no plain version runs for the kernel."""
    w = torch.randn((n, m), generator=gen, device="cuda")
    wq = quantize_weights(w, QuantSpec(bits=q, group_size=gs))
    x = torch.randn((b, n), generator=gen, device="cuda")
    c0, l0 = dict(qref.CALLS), qkernel.LAUNCHES["quant_matmul"]
    got = qops.quant_matmul(x, wq)
    assert qref.CALLS == c0
    assert qkernel.LAUNCHES["quant_matmul"] == l0 + 1
    want = qops.quant_matmul(x, wq, impl="reference")
    torch.cuda.synchronize()
    tol = 1e-5 * want.abs() + 1e-5 * float(want.abs().max())
    assert bool(((got - want).abs() <= tol).all())


def test_quant_matmul_rejects_what_the_kernel_does_not_take(gen):
    w = torch.randn((320, 64), generator=gen, device="cuda")
    wq = quantize_weights(w, QuantSpec(bits=3))
    with pytest.raises(ValueError, match="q in"):
        qops.quant_matmul(torch.randn((2, 320), device="cuda"), wq, bn=160)
    wq2 = quantize_weights(w, QuantSpec(bits=2))
    words = qops.packed_codes(wq2)
    with pytest.raises(ValueError, match="float32"):
        qkernel.quant_matmul(torch.zeros((2, 320), device="cuda",
                                         dtype=torch.bfloat16), words,
                             torch.zeros((1, 64), device="cuda"), q=2,
                             zero=2, bn=320)


# B2 through the member table: (n, m, q, p, groups) per member. Ragged M
# (90, 130, 200, 40: scalar loads), mixed q/p and n, grouped scales, and
# llama2-7b's q/k/v and up/gate; with B = 1, 4 and 64 the plans cover one
# split and several.
GROUPS = {
    "ragged mixed q": [(300, 90, 2, 4, 1), (300, 130, 3, 4, 1),
                       (300, 40, 4, 4, 1)],
    "mixed q/p and n": [(300, 90, 2, 2, 1), (300, 90, 3, 3, 1),
                        (300, 90, 4, 2, 1), (160, 40, 5, 4, 1)],
    "grouped scales": [(320, 200, 2, 2, 2), (480, 130, 4, 3, 3),
                       (512, 256, 4, 2, 1)],
    "q/k/v": [(4096, 4096, 2, 4, 1)] * 3,
    "up/gate": [(4096, 11008, 2, 4, 1)] * 2,
}


@pytest.mark.parametrize("name", list(GROUPS))
@pytest.mark.parametrize("b", [1, 4, 64])
def test_group_gemv_bitwise_equals_plain_and_per_leaf(gen, name, b):
    cfgs = GROUPS[name]
    ws = [_leaf(gen, n, m, q, g) for n, m, q, _p, g in cfgs]
    specs = [QuantSpec(bits=p) for _n, _m, _q, p, _g in cfgs]
    xs = [torch.randn((b, n), generator=gen, device="cuda")
          for n, *_ in cfgs]
    plan = program.build_plan(tuple(
        (w.n, w.m, w.bits, w.scale.shape[0], w.zero, s.bits,
         program.static_zero(s)) for w, s in zip(ws, specs)))
    table = program.member_table(plan, ws)
    _, splits = table.split(b, kernel._sms(torch.device("cuda")))
    c0, l0 = dict(ref.CALLS), dict(program.LAUNCHES)
    got = program.run_program(plan, ws, xs, specs, table=table)
    torch.cuda.synchronize()
    assert ref.CALLS == c0                   # no plain version on the card
    assert program.LAUNCHES["program_gemv"] == l0["program_gemv"] + 1
    assert program.LAUNCHES["program_gemv_fold"] == \
        l0["program_gemv_fold"] + int(splits > 1)
    for g_, w, x, spec in zip(got, ws, xs, specs):
        assert torch.equal(g_, ops.bitplane_gemv_bitserial(x, w, spec))
        assert torch.equal(g_, ops.bitplane_gemv_bitserial(
            x, w, spec, impl="reference"))
    # the kernel against the member table's plain version on the same
    # codes: padded with z_a to the member's blocks, then 3 columns wider
    codes = [torch.nn.functional.pad(torch.nn.functional.pad(
        torch.randint(0, 1 << M.p, (b, w.n), generator=gen,
                      device="cuda").to(torch.uint8),
        (0, M.n_pad - w.n), value=M.z_a), (0, 3))
        for M, w in zip(table.members, ws)]
    k = program.group_gemv(table, codes)
    want = ref.group_gemv_ref(codes, table.planes, table.scales,
                              table.members, table.cols)
    torch.cuda.synchronize()
    assert torch.equal(k, want)


@pytest.mark.parametrize("name", ["ragged mixed q", "mixed q/p and n",
                                  "grouped scales", "q/k/v"])
@pytest.mark.parametrize("b", [1, 4])
def test_slot_major_program_gemv_on_the_new_kernel(gen, name, b):
    """The slot-major entry, each slot a member described by strides,
    bitwise against its plain version and, gathered, against per-leaf
    B1."""
    cfgs = GROUPS[name]
    ws = [_leaf(gen, n, m, q, g) for n, m, q, _p, g in cfgs]
    ps = [p for *_, p, _g in cfgs]
    specs = [QuantSpec(bits=p) for p in ps]
    plan = program.build_plan(tuple(
        (w.n, w.m, w.bits, w.scale.shape[0], w.zero, s.bits,
         program.static_zero(s)) for w, s in zip(ws, specs)))
    packed = program.pack_group(plan, ws, "cuda")
    xs = [torch.randn((b, w.n), generator=gen, device="cuda") for w in ws]
    aqs = [quantize_activations(x, s) for x, s in zip(xs, specs)]
    codes_t = program.pack_codes(plan, [a.values for a in aqs])
    l0 = program.LAUNCHES["program_gemv"]
    got = program.program_gemv(plan, codes_t, *packed)
    want = ref.program_gemv_ref(codes_t, *packed, q_max=plan.q_max,
                                p_max=plan.p_max, bn=plan.bn_max)
    torch.cuda.synchronize()
    assert program.LAUNCHES["program_gemv"] == l0 + 1
    assert torch.equal(got, want)
    for o, a, w, x, s in zip(program.gather_outputs(plan, got), aqs, ws, xs,
                             specs):
        assert torch.equal(o * a.scale,
                           ops.bitplane_gemv_bitserial(x, w, s))


def test_group_gemv_rejects_what_the_kernel_does_not_take(gen):
    ws = [_leaf(gen, 256, 64, 2, 1) for _ in range(9)]
    table = program.group_table(ws, 4)
    codes = torch.full((2, 256), 8, dtype=torch.uint8, device="cuda")
    with pytest.raises(ValueError, match="members"):
        program.group_gemv(table, [codes] * 9)
    table = program.group_table(ws[:3], 4)
    with pytest.raises(ValueError, match="uint8"):
        program.group_gemv(table, [codes.int()] * 3)
    with pytest.raises(ValueError, match="uint8"):
        program.group_gemv(table, [codes[:, :128]] * 3)
    with pytest.raises(ValueError, match="on cuda"):
        program.group_gemv(table, [codes, codes.cpu(), codes])


# (n, m, B, q, group size): several splits (decode), one split (64-row
# prefill of a wide output), grouped scales with 32 tiles, ragged ends
QMM_PLANS = [(4096, 4096, 4, 2, -1), (11008, 4096, 4, 2, -1),
             (4096, 32000, 4, 2, -1), (4096, 32000, 64, 2, -1),
             (4096, 11008, 64, 2, -1), (4096, 4096, 64, 2, 128),
             (11008, 200, 64, 4, -1), (1000, 90, 64, 1, -1),
             (2048, 130, 9, 8, 256)]


@pytest.mark.parametrize("n,m,b,q,gs", QMM_PLANS)
def test_quant_matmul_split_plans(gen, n, m, b, q, gs):
    """B5 at one split and several, within rtol 1e-5 / atol 1e-5·max of
    its plain version; the fold launches as the plan says."""
    w = torch.randn((n, m), generator=gen, device="cuda")
    wq = quantize_weights(w, QuantSpec(bits=q, group_size=gs))
    x = torch.randn((b, n), generator=gen, device="cuda")
    bn, _ = ops._pick_blocks(n, m, None, None, gs if gs > 0 else None)
    _, splits = kernel.split_plan(-(-n // bn), m, b,
                                  kernel._sms(torch.device("cuda")))
    l0 = dict(qkernel.LAUNCHES)
    got = qops.quant_matmul(x, wq)
    want = qops.quant_matmul(x, wq, impl="reference")
    torch.cuda.synchronize()
    assert qkernel.LAUNCHES["quant_matmul"] == l0["quant_matmul"] + 1
    assert qkernel.LAUNCHES["quant_matmul_fold"] == \
        l0["quant_matmul_fold"] + int(splits > 1)
    tol = 1e-5 * want.abs() + 1e-5 * float(want.abs().max())
    assert bool(((got - want).abs() <= tol).all())


# B3 over an expert stack: (E, R, n, m, q, groups, counts). qwen2-moe's
# up/gate and down at R = 8, with every expert's rows and with 16 routed
# experts of 1-4 rows; ragged M (not a multiple of 4 or of 128) and ragged
# R; E = 1; an empty expert beside a full one; splits of one tile folded
# per expert, one of them empty; grouped scales (a contiguous tile-scale
# stack)
EXPERT_SHAPES = [
    (64, 8, 2048, 1408, 4, 1, None), (64, 8, 1408, 2048, 4, 1, None),
    (64, 8, 2048, 1408, 4, 1, "routed"), (64, 8, 1408, 2048, 4, 1, "routed"),
    (5, 6, 300, 90, 3, 1, None), (3, 5, 1000, 130, 2, 1, [5, 0, 2]),
    (1, 8, 2048, 1408, 4, 1, None), (1, 8, 1408, 2048, 4, 1, [3]),
    (4, 8, 2048, 1408, 4, 1, [0, 8, 4, 5]),
    (1, 4, 11008, 256, 2, 1, None), (2, 4, 4096, 130, 2, 1, [0, 3]),
    (3, 4, 2048, 130, 4, 4, [4, 1, 0])]


def _expert_stack(gen, e, n, m, q, g):
    from repro_torch.serve.quantize import _stack
    return _stack([_leaf(gen, n, m, q, g) for _ in range(e)])


def _expert_counts(gen, e, r, spec):
    if spec is None:
        return None
    if spec == "routed":          # 16 experts with 1..4 rows, the rest 0
        counts = torch.zeros(e, dtype=torch.int32, device="cuda")
        pick = torch.randperm(e, generator=gen, device="cuda")[:16]
        counts[pick] = torch.randint(1, 5, (16,), generator=gen,
                                     device="cuda", dtype=torch.int32)
        return counts
    return torch.tensor(spec, dtype=torch.int32, device="cuda")


@pytest.mark.parametrize("e,r,n,m,q,g,spec", EXPERT_SHAPES)
def test_gemv_f_experts_within_tolerance(gen, e, r, n, m, q, g, spec):
    bw = _expert_stack(gen, e, n, m, q, g)
    counts = _expert_counts(gen, e, r, spec)
    x = torch.randn((e, r, n), generator=gen, device="cuda")
    if counts is not None:        # rows past a count are zero, as dispatched
        live = torch.arange(r, device="cuda") < counts[:, None]
        x = torch.where(live[..., None], x, 0.0)
    k0, c0 = dict(kernel.LAUNCHES), dict(ref.CALLS)
    got = ops.bitplane_gemv(x, bw, counts=counts)
    torch.cuda.synchronize()
    assert ref.CALLS == c0
    bn, _ = ops._pick_blocks(n, m, None, None, n // g if g > 1 else None)
    _, splits = kernel.split_plan(-(-n // bn), m, r,
                                  kernel._sms(torch.device("cuda")),
                                  experts=e)
    assert kernel.LAUNCHES["gemv_f_experts"] == k0["gemv_f_experts"] + 1
    assert kernel.LAUNCHES["gemv_f_experts_fold"] == \
        k0["gemv_f_experts_fold"] + int(splits > 1)
    assert kernel.LAUNCHES["gemv_f"] == k0["gemv_f"]
    for want in (ops.bitplane_gemv(x, bw, impl="reference", counts=counts),
                 ops.bitplane_gemv(x, bw, impl="reference")):
        tol = 1e-5 * want.abs() + 1e-5 * float(want.abs().max())
        assert bool(((got - want).abs() <= tol).all())
    if counts is not None:
        for i, c in enumerate(counts.tolist()):
            assert not bool(got[i, c:].any())
    if e <= 5:                    # each expert as a leaf through B3
        for i in range(e):
            want = ops.bitplane_gemv(x[i], bw[i])
            tol = 1e-5 * want.abs() + 1e-5 * float(want.abs().max())
            assert bool(((got[i] - want).abs() <= tol).all())


def test_gemv_f_experts_rejects_bad_inputs(gen):
    bw = _expert_stack(gen, 3, 256, 40, 2, 1)
    x = torch.randn((3, 4, 256), generator=gen, device="cuda")
    with pytest.raises(ValueError, match="activations"):
        ops.bitplane_gemv(x[:2], bw)
    with pytest.raises(ValueError, match="counts"):
        ops.bitplane_gemv(x, bw, counts=torch.zeros(
            3, dtype=torch.int64, device="cuda"))
    with pytest.raises(ValueError, match="counts"):
        ops.bitplane_gemv(x[0], bw[0], counts=torch.zeros(
            3, dtype=torch.int32, device="cuda"))
    scale_t = bw.scale.expand(3, 1, 40)
    with pytest.raises(ValueError, match="contiguous"):
        kernel.gemv_f_experts(x, bw.planes.transpose(2, 3), scale_t, q=2,
                              zero=bw.zero, bn=256)
    with pytest.raises(ValueError, match="experts"):
        kernel.gemv_f_experts(x, bw.planes[:2], scale_t, q=2, zero=bw.zero,
                              bn=256)


# head dims between the built sizes: (B, S, H, Hkv, D, window). D = 100
# makes a K/V row of 200 (bf16) or 100 (int8) bytes, not whole 16-byte
# loads (f32's 400 bytes are 25 of them)
HEAD_DIM_SHAPES = [(2, 300, 8, 4, 16, None), (3, 1000, 8, 2, 80, 100),
                   (2, 513, 4, 4, 100, None), (4, 4096, 32, 32, 112, None),
                   (1, 77, 4, 1, 100, 16),
                   # above the fast body's 256: the generic body
                   (2, 700, 8, 4, 320, None), (2, 300, 4, 2, 1000, 100)]


@pytest.mark.parametrize("b,s,h,hkv,d,window", HEAD_DIM_SHAPES)
@pytest.mark.parametrize("q_dtype,kv", [
    (torch.float32, torch.float32), (torch.float32, torch.int8),
    (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.int8)])
def test_decode_attention_at_any_head_dim(gen, b, s, h, hkv, d, window,
                                          q_dtype, kv):
    test_decode_attention_within_tolerance(gen, b, s, h, hkv, d, window,
                                           q_dtype, kv)


# bf16 stacks, (E, R, N, M, q, groups, counts): qwen2-moe's stacks at full
# capacity and a decode step's counts; ragged M and N; R = 12 (two
# n-tiles) and R = 40 (three 16-row chunks); an empty expert beside a full
# one; grouped scales; q = 1, 3 and 8
BF16_EXPERT_SHAPES = [
    (64, 8, 2048, 1408, 4, 1, None), (64, 8, 1408, 2048, 4, 1, None),
    (64, 8, 2048, 1408, 4, 1, "routed"), (64, 8, 1408, 2048, 4, 1, "routed"),
    (5, 6, 300, 90, 3, 1, None), (3, 12, 1000, 130, 2, 1, [12, 0, 5]),
    (2, 40, 2048, 256, 4, 1, [40, 17]), (4, 8, 2048, 1408, 4, 1, [0, 8, 3, 0]),
    (3, 4, 2048, 130, 4, 4, [4, 1, 0]), (2, 8, 640, 200, 8, 1, None),
    (1, 8, 1408, 2048, 1, 1, [3])]


@pytest.mark.parametrize("e,r,n,m,q,g,spec", BF16_EXPERT_SHAPES)
def test_bf16_expert_stack_on_the_tensor_cores(gen, e, r, n, m, q, g, spec):
    """The bf16 stack goes to `experts_mma_kernel` unpadded (one launch,
    plus a fold where the plan over the live experts splits), within rtol
    1e-5 / atol 1e-5·max|plain| of its plain version, rows past a count
    and experts without rows zero."""
    bw = _expert_stack(gen, e, n, m, q, g)
    counts = _expert_counts(gen, e, r, spec)
    x = torch.randn((e, r, n), generator=gen, device="cuda").to(
        torch.bfloat16)
    if counts is not None:
        rows = torch.arange(r, device="cuda") < counts[:, None]
        x = torch.where(rows[..., None], x, torch.zeros((), dtype=x.dtype,
                                                        device="cuda"))
    live = e if counts is None else min(e, 16 if spec == "routed" else e)
    k0, c0 = dict(kernel.LAUNCHES), dict(ref.CALLS)
    got = ops.bitplane_gemv(x, bw, counts=counts, live=live)
    torch.cuda.synchronize()
    assert ref.CALLS == c0
    bn, _ = ops._pick_blocks(n, m, None, None, n // g if g > 1 else None)
    _, splits = kernel.mma_plan(-(-n // bn), m, r,
                                kernel._sms(torch.device("cuda")), e, live)
    assert kernel.LAUNCHES["gemv_f_experts_mma"] == \
        k0["gemv_f_experts_mma"] + 1
    assert kernel.LAUNCHES["gemv_f_experts_mma_fold"] == \
        k0["gemv_f_experts_mma_fold"] + int(splits > 1)
    assert kernel.LAUNCHES["gemv_f_experts"] == k0["gemv_f_experts"]
    want = ops.bitplane_gemv(x, bw, impl="reference", counts=counts)
    tol = 1e-5 * want.abs() + 1e-5 * float(want.abs().max())
    assert bool(((got - want).abs() <= tol).all()), \
        float((got - want).abs().max())
    if counts is not None:
        for i, c in enumerate(counts.tolist()):
            assert not bool(got[i, c:].any())
    # the f32 stack of the same values through B3's block body
    f32 = ops.bitplane_gemv(x.float(), bw, counts=counts)
    assert bool(((got - f32).abs() <= tol).all())


def test_bf16_expert_stack_rejects_what_the_kernel_does_not_take(gen):
    bw = _expert_stack(gen, 3, 256, 40, 2, 1)
    x = torch.randn((3, 4, 256), generator=gen, device="cuda").to(
        torch.bfloat16)
    scale_t = bw.scale.expand(3, 1, 40)
    with pytest.raises(ValueError, match="zero"):
        kernel.gemv_f_experts(x, bw.planes, scale_t, q=2, zero=200, bn=256)
    with pytest.raises(ValueError, match="planes"):
        kernel.gemv_f_experts(x[..., :200].contiguous(), bw.planes, scale_t,
                              q=2, zero=bw.zero, bn=256)
    with pytest.raises(ValueError, match="contiguous"):
        kernel.gemv_f_experts(x.transpose(1, 2).contiguous().transpose(1, 2),
                              bw.planes, scale_t, q=2, zero=bw.zero, bn=256)
