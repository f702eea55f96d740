"""Host-side plan of the bit-plane GeMV kernels B1 `gemv_bs` and B3
`gemv_f` (`kernels/bitplane_gemv/kernel.py`): the split of the reduction
tiles over blocks and the workspace that the fold of the splits takes.
These run on the CPU; the kernels themselves run only on the card
(`tests/test_torch_cuda.py`).

The last tests replay B1's decomposition (csrc/bitplane_gemv.cu) in plain
PyTorch: weight codes of 4 rows spread into the bytes of a word, work
items of `unit_words(q)` words whose exact integer correction is
Σaw − z_w·Σa − z_a·Σw + rows·z_a·z_w, summed per tile, then the f32
epilogue in tile order. That must give the plain version's output bit for
bit: it checks the algebra and the bit tricks the kernel relies on, not
the CUDA code.
"""
import pytest
import torch

from repro_torch.core.bitplane import make_bitplane_weights
from repro_torch.core.quant import QuantSpec, quantize_activations
from repro_torch.kernels.bitplane_gemv import kernel, ops, ref

H100_SMS = 132   # SMs of an H100 SXM, the card the plan is written for

# (n, m, B): llama2-7b's decode shapes (q/k/v/wo, down, up/gate, lm_head),
# a prefill of 64 rows, and the card tests' ragged ones
PLAN_SHAPES = [(4096, 4096, 4), (11008, 4096, 4), (4096, 11008, 4),
               (4096, 32000, 4), (4096, 4096, 64), (300, 90, 3),
               (11008, 64, 4), (4096, 200, 17), (1000, 130, 9),
               (512, 40, 1)]


@pytest.mark.parametrize("n,m,b", PLAN_SHAPES)
def test_split_plan_covers_every_tile_once(n, m, b):
    tiles = -(-n // 512)
    tpb, splits = kernel.split_plan(tiles, m, b, H100_SMS)
    assert 1 <= tpb <= kernel.MAX_TILES_PER_BLOCK
    assert (splits - 1) * tpb < tiles <= splits * tpb
    blocks = -(-m // kernel.STRIP) * -(-b // kernel.ROWS) * splits
    # as many blocks as the target asks, unless the tiles run out first
    # (one split per tile)
    assert blocks >= kernel.BLOCKS_PER_SM * H100_SMS or splits == tiles


def test_split_plan_on_the_main_path():
    """llama2-7b at B = 4: every shape runs several blocks per SM."""
    got = {(n, m): kernel.split_plan(-(-n // 512), m, 4, H100_SMS)
           for n, m, _ in PLAN_SHAPES[:4]}
    assert got == {(4096, 4096): (1, 8), (11008, 4096): (1, 22),
                   (4096, 11008): (1, 8), (4096, 32000): (2, 4)}
    # a wide output at a 64-row prefill fills the card without a split;
    # a narrow one splits down to a tile a block, at most 8 tiles a block
    assert kernel.split_plan(8, 32000, 64, H100_SMS) == (8, 1)
    assert kernel.split_plan(100, 40, 1, H100_SMS) == (1, 100)
    assert kernel.split_plan(100, 32000, 64, H100_SMS) == (8, 13)
    with pytest.raises(ValueError, match="tiles=0"):
        kernel.split_plan(0, 40, 1, H100_SMS)


@pytest.mark.parametrize("kind,splits,want", [
    ("gemv_bs", 1, (0,)), ("gemv_f", 1, (0,)),
    ("gemv_bs", 4, (8, 4, 32000)), ("gemv_f", 4, (4, 4, 32000))])
def test_workspace_shape(kind, splits, want):
    """B1 keeps every tile's int32 correction (its fold runs the epilogue
    in tile order), B3 one f32 partial per split; one split needs none."""
    assert kernel.workspace_shape(kind, 8, splits, 4, 32000) == want


def _unit_words(q: int) -> int:
    """Words of one work item (the CUDA source's `unit_words`)."""
    return 1 if q >= 4 else 4 // q


def _spread(words, j4: int):
    """The kernel's byte spread of rows 4·j4..4·j4+3: for planes (q, ...)
    of uint32 words (held in int64), the word whose byte k is the code
    Σ_i 2^i·bit_{4·j4+k}(plane i)."""
    out = torch.zeros_like(words[0])
    for i in range(words.shape[0]):
        nib = (words[i] >> (4 * j4)) & 0xF
        out |= ((nib * (0x00204081 << i)) & 0xFFFFFFFF) & (0x01010101 << i)
    return out


@pytest.mark.parametrize("q", [1, 2, 5, 8])
def test_byte_spread_gives_the_codes_of_four_rows(q):
    gen = torch.Generator().manual_seed(q)
    words = torch.randint(0, 1 << 32, (q, 64), generator=gen,
                          dtype=torch.int64)
    for j4 in range(8):
        got = _spread(words, j4)
        for k in range(4):
            code = sum(((words[i] >> (4 * j4 + k)) & 1) << i
                       for i in range(q))
            assert torch.equal((got >> (8 * k)) & 0xFF, code)


def _emulate_gemv_bs(codes, planes, scale_tiles, *, q, p, z_a, z_w, bn):
    """B1's decomposition in plain PyTorch (see the module docstring)."""
    b, n_pad = codes.shape
    _, n_words, m = planes.shape
    tiles, wpt, u = n_pad // bn, bn // 32, _unit_words(q)
    a = codes.to(torch.int64) & ((1 << p) - 1)
    w32 = planes.to(torch.int64) & 0xFFFFFFFF
    corr = torch.zeros((tiles, b, m), dtype=torch.int64)
    for t in range(tiles):
        for w0 in range(t * wpt, (t + 1) * wpt, u):
            live = min(u, (t + 1) * wpt - w0, n_words - w0)
            if live <= 0:
                continue
            acc = torch.zeros((b, m), dtype=torch.int64)
            for w in range(w0, w0 + live):
                for j4 in range(8):
                    wb = _spread(w32[:, w], j4)               # (M,)
                    rows = a[:, 32 * w + 4 * j4:32 * w + 4 * j4 + 4]
                    for k in range(4):                        # one dp4a
                        acc += rows[:, k:k + 1] * ((wb >> (8 * k)) & 0xFF)
            sum_a = a[:, 32 * w0:32 * (w0 + live)].sum(1, keepdim=True)
            sum_w = sum(torch.stack([(w32[i, w0:w0 + live] >> j) & 1
                                     for j in range(32)]).sum((0, 1)) << i
                        for i in range(q))
            corr[t] += (acc - z_w * sum_a - z_a * sum_w
                        + 32 * live * z_a * z_w)
    return ref._fma_chain(corr.to(torch.float64), scale_tiles[:, None, :])


# (n, m, q, p, groups, B): ragged n, q and p up to 8, grouped scales
EMULATED = [(300, 90, 2, 4, 1, 3), (1000, 130, 3, 2, 1, 5),
            (512, 40, 5, 4, 2, 1), (640, 33, 8, 8, 1, 2),
            (1376, 64, 2, 8, 1, 4), (1024, 40, 1, 3, 4, 2)]


@pytest.mark.parametrize("n,m,q,p,g,b", EMULATED)
def test_gemv_bs_decomposition_is_bitwise_the_plain_version(n, m, q, p, g,
                                                             b):
    gen = torch.Generator().manual_seed(n + m + q + p)
    gs = n // g if g > 1 else None
    bw = make_bitplane_weights(torch.randn((n, m), generator=gen),
                               QuantSpec(bits=q, group_size=gs or -1))
    aq = quantize_activations(torch.randn((b, n), generator=gen),
                              QuantSpec(bits=p))
    bn, _ = ops._pick_blocks(n, m, None, None, gs)
    codes = ops._pad_axis(aq.values, bn, 1, value=aq.zero).contiguous()
    scale_t = ops._expand_scales(bw, bn, codes.shape[1])
    kw = dict(q=q, p=p, z_a=aq.zero, z_w=bw.zero, bn=bn)
    want = ref.gemv_bs_ref(codes, bw.planes, scale_t, **kw)
    got = _emulate_gemv_bs(codes, bw.planes, scale_t, **kw)
    assert torch.equal(got, want)


def test_card_shapes_reach_every_path_of_the_plan():
    """The shapes of the card tests (tests/test_torch_cuda.py) reach each
    path of the kernels: one tile; one block owning several tiles; splits
    of one tile; splits of several tiles, evenly and with a ragged last
    one."""
    from test_torch_cuda import SHAPES
    paths = set()
    for n, m, q, p, g, b in SHAPES:
        bn, _ = ops._pick_blocks(n, m, None, None, n // g if g > 1 else None)
        tiles = -(-n // bn)
        tpb, splits = kernel.split_plan(tiles, m, b, H100_SMS)
        paths.add("one tile" if tiles == 1
                  else "one block" if splits == 1
                  else "splits of one tile" if tpb == 1
                  else "ragged splits" if tiles % tpb
                  else "even splits")
    assert paths == {"one tile", "one block", "splits of one tile",
                     "ragged splits", "even splits"}
