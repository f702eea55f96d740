"""Port parity: the PUD device model and its adders, on the CPU.

The port's `Subarray`/`BankArray` (bit state in torch, ledger in numpy on
the host) and the functional adders of `core/pud/adder.py` against the JAX
package's numpy originals on the same bits: MAJX (majority, inputs
destroyed, unreliable columns untouched, fault flips), the dual-track
ripple adder micro-op by micro-op, the batched and wave-parallel adders,
the per-(request, tile) ledger with its lane mask, and the error messages.
Every comparison is bitwise: bit rows and op counts.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core.pud import adder as j_adder
from repro.core.pud import device as j_dev
from repro.core.pud.faults import FaultModel as JFaultModel
from repro.core.pud.layout import HorizontalLayout
from repro_torch.core.pud import adder as t_adder
from repro_torch.core.pud import device as t_dev
from repro_torch.core.pud.faults import FaultModel as TFaultModel
from test_torch_model import fresh_jax_caches  # noqa: F401


def _bits(t) -> np.ndarray:
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _c(x):
    """Op counts of either package as plain dicts (nested lists kept)."""
    if isinstance(x, (list, tuple)):
        return [_c(v) for v in x]
    return x.asdict()


def _load(j_obj, t_obj, start):
    j_obj.data[:] = start
    t_obj.data[:] = torch.from_numpy(start)


def test_majx_is_majority_and_destroys_inputs():
    sub = t_dev.Subarray(rows=16, cols=8)
    for i, bits in enumerate([[1, 0, 1, 1, 0, 0, 1, 0],
                              [1, 1, 0, 1, 0, 1, 0, 0],
                              [0, 0, 1, 1, 1, 0, 0, 0]]):
        sub.host_write_row(i, np.array(bits))
    sub.majx([0, 1, 2])
    expect = np.array([1, 0, 1, 1, 0, 0, 0, 0])
    for r in range(3):  # result written back to ALL activated rows
        assert (_bits(sub.data[r]) == expect).all()
    assert (sub.counts.maj3, sub.counts.host_bits_written) == (1, 24)


def test_subarray_primitives_match_jax(rng):
    rel = rng.random(24) > 0.25
    start = rng.integers(0, 2, size=(16, 24)).astype(np.uint8)
    js, ts = (j_dev.Subarray(rows=16, cols=24, reliable_cols=rel),
              t_dev.Subarray(rows=16, cols=24, reliable_cols=rel))
    _load(js, ts, start)
    for sa in (js, ts):
        sa.row_copy(0, 9)
        sa.majx([1, 2, 3])
        sa.majx([4, 5, 6, 7, 8])
        sa.majx([9, 10, 11, 12, 13, 14, 15])
        sa.host_write_row(2, np.ones(24, np.uint8))
    np.testing.assert_array_equal(_bits(ts.data), js.data)
    assert _c(ts.counts) == _c(js.counts)
    np.testing.assert_array_equal(_bits(ts.host_read_row(5)),
                                  js.host_read_row(5))
    assert ts.counts.host_bits_read == js.counts.host_bits_read == 24


def test_dual_track_adder_single_add():
    lay = HorizontalLayout(n_sub=4, m_sub=8, q=1, p=2, subarray_cols=16)
    sub = t_dev.Subarray(rows=512, cols=16)
    row = np.zeros(16, np.uint8)
    row[:8] = [1, 0, 1, 1, 0, 1, 0, 0]
    sub.host_write_row(lay.zero_row, np.zeros(16, np.uint8))
    sub.host_write_row(lay.one_row, np.ones(16, np.uint8))
    sub.host_write_row(lay.matrix_rows[0], row)
    sub.host_write_row(lay.inv_matrix_rows[0], 1 - row)
    t_adder.clear_accumulator(sub, lay)
    for k in (0, 1, 0):  # acc += row<<0; += row<<1; += row<<0  → 4·row
        t_adder.add_row_at_offset(sub, lay, lay.matrix_rows[0],
                                  lay.inv_matrix_rows[0], k, lay.r - k)
    acc = _bits(sub.data[lay.acc_rows])
    vals = (acc.astype(np.int64)
            * (1 << np.arange(lay.r, dtype=np.int64))[:, None]).sum(0)
    assert (vals[:8] == 4 * row[:8]).all()
    acc_c = _bits(sub.data[lay.acc_c_rows])
    assert ((acc + acc_c) == 1).all()           # complement track


@settings(max_examples=8, deadline=None)
@given(n_sub=st.integers(1, 6), p=st.integers(1, 3),
       seed=st.integers(0, 2 ** 16), unreliable=st.booleans())
def test_adders_match_jax_bitwise(n_sub, p, seed, unreliable):
    """The naive ripple adder and the batched one, on both packages from
    the same rows: accumulator rows (both tracks) and counts bitwise, and
    the batched path equal to the naive one on reliable columns."""
    r = np.random.default_rng(seed)
    cols = 12
    lay = HorizontalLayout(n_sub=n_sub, m_sub=cols, q=1, p=p,
                           subarray_cols=cols)
    rel = (r.random(cols) > 0.3) if unreliable else None
    rows = r.integers(0, 2, size=(n_sub, cols)).astype(np.uint8)
    adds = [(int(r.integers(0, n_sub)), int(r.integers(0, p)))
            for _ in range(4)]
    got = {}
    for name, pkg_dev, pkg_add in (("jax", j_dev, j_adder),
                                   ("port", t_dev, t_adder)):
        for mode in ("naive", "batched"):
            sa = pkg_dev.Subarray(rows=lay.rows_used, cols=cols,
                                  reliable_cols=rel)
            sa.host_write_row(lay.zero_row, np.zeros(cols, np.uint8))
            sa.host_write_row(lay.one_row, np.ones(cols, np.uint8))
            for j in range(n_sub):
                sa.host_write_row(lay.matrix_rows[j], rows[j])
                sa.host_write_row(lay.inv_matrix_rows[j], 1 - rows[j])
            pkg_add.clear_accumulator(sa, lay)
            if mode == "naive":
                for j, k in adds:
                    pkg_add.add_row_at_offset(
                        sa, lay, lay.matrix_rows[j], lay.inv_matrix_rows[j],
                        k, lay.r - k)
            else:
                for k in range(p):
                    js = [j for j, kk in adds if kk == k]
                    pkg_add.add_rows_batched(sa, lay, np.asarray(js), k,
                                             n_zero_adds=1)
            got[name, mode] = (_bits(sa.data).copy(), sa.counts)
    for mode in ("naive", "batched"):
        np.testing.assert_array_equal(got["port", mode][0],
                                      got["jax", mode][0])
        assert _c(got["port", mode][1]) == _c(got["jax", mode][1])
    if rel is None:
        acc = np.asarray(lay.acc_rows + lay.acc_c_rows)
        np.testing.assert_array_equal(got["port", "batched"][0][acc],
                                      got["port", "naive"][0][acc])


def test_bankarray_primitives_match_subarray_and_jax(rng):
    """Broadcast RowCopy/MAJX on the (tiles, rows, cols) BankArray equal the
    per-subarray primitives applied to each tile, and the JAX package's
    BankArray bit for bit."""
    tiles, rows, cols = 3, 16, 8
    start = rng.integers(0, 2, size=(tiles, rows, cols)).astype(np.uint8)
    bank = t_dev.BankArray(tiles, rows=rows, cols=cols)
    jbank = j_dev.BankArray(tiles, rows=rows, cols=cols)
    _load(jbank, bank, start)
    subs = []
    for t in range(tiles):
        sub = t_dev.Subarray(rows=rows, cols=cols)
        sub.data[:] = torch.from_numpy(start[t])
        subs.append(sub)
    for b in (bank, jbank):
        b.row_copy(0, 5)
        b.majx([1, 2, 3])
        b.majx([4, 5, 6, 7, 8])
    for t, sub in enumerate(subs):
        sub.row_copy(0, 5)
        sub.majx([1, 2, 3])
        sub.majx([4, 5, 6, 7, 8])
        np.testing.assert_array_equal(_bits(bank.data[t]), _bits(sub.data))
    np.testing.assert_array_equal(_bits(bank.data), jbank.data)
    counts = bank.tile_counts()
    assert _c(counts) == _c(jbank.tile_counts())
    for t, sub in enumerate(subs):
        assert counts[t].row_copy == sub.counts.row_copy == 1
        assert counts[t].maj3 == sub.counts.maj3 == 1
        assert counts[t].maj5 == sub.counts.maj5 == 1


def _wave_bank(pkg, lay, rows, batch=None, rel=None):
    tiles, _, cols = rows.shape
    bank = pkg.BankArray(tiles, rows=lay.rows_used, cols=cols, batch=batch,
                         reliable_cols=rel)
    bank.host_write_row(lay.zero_row, np.zeros(cols, np.uint8))
    bank.host_write_row(lay.one_row, np.ones(cols, np.uint8))
    bank.host_write_rows(lay.matrix_rows, rows)
    bank.host_write_rows(lay.inv_matrix_rows, 1 - rows)
    return bank


def test_bankarray_wave_adder_matches_columnwise_sum(rng):
    """clear + add_rows_batched_wave leaves each tile's accumulator rows at
    the masked column sums (and the JAX package's rows, bitwise)."""
    tiles, n_sub, p, cols = 4, 6, 2, 12
    lay = HorizontalLayout(n_sub=n_sub, m_sub=cols, q=1, p=p,
                           subarray_cols=cols)
    rows = rng.integers(0, 2, size=(tiles, n_sub, cols)).astype(np.uint8)
    masks = rng.integers(0, 2, size=(tiles, n_sub)).astype(bool)
    bank = _wave_bank(t_dev, lay, rows)
    jbank = _wave_bank(j_dev, lay, rows)
    t_adder.clear_accumulator(bank, lay)
    j_adder.clear_accumulator(jbank, lay)
    acc_t = t_adder.add_rows_batched_wave(bank, lay, masks, offset=1)
    acc_j = j_adder.add_rows_batched_wave(jbank, lay, masks, offset=1)
    expect = (masks[:, :, None] * rows).sum(axis=1) << 1
    np.testing.assert_array_equal(acc_t.numpy(), expect)
    np.testing.assert_array_equal(acc_t.numpy(), acc_j)
    np.testing.assert_array_equal(_bits(bank.data), jbank.data)
    assert _c(bank.tile_counts()) == _c(jbank.tile_counts())
    acc = _bits(bank.data[:, lay.acc_rows]).astype(np.int64)
    vals = (acc * (1 << np.arange(lay.r, dtype=np.int64))[None, :, None]
            ).sum(axis=1)
    np.testing.assert_array_equal(vals, expect)
    acc_c = _bits(bank.data[:, lay.acc_c_rows])
    np.testing.assert_array_equal(acc.astype(np.uint8) + acc_c,
                                  np.ones_like(acc_c))


@pytest.mark.parametrize("unreliable", [False, True])
def test_batched_wave_adder_and_write_match_jax(rng, unreliable):
    """The batch axis: B masks against the same resident rows, p offsets
    with deferred writes, zero-add billing, a tile subset written back —
    values, rows and ledger bitwise against the JAX package."""
    tiles, B, n_sub, p, cols = 3, 2, 5, 3, 12
    lay = HorizontalLayout(n_sub=n_sub, m_sub=cols, q=1, p=p,
                           subarray_cols=cols)
    rel = (rng.random(cols) > 0.3) if unreliable else None
    rows = rng.integers(0, 2, size=(tiles, n_sub, cols)).astype(np.uint8)
    masks = rng.integers(0, 2, size=(p, B, tiles, n_sub)).astype(bool)
    zeros = rng.integers(0, 3, size=(B, tiles))
    out = {}
    for pkg_dev, pkg_add in ((j_dev, j_adder), (t_dev, t_adder)):
        bank = _wave_bank(pkg_dev, lay, rows, batch=B, rel=rel)
        pkg_add.clear_accumulator(bank, lay)
        acc = None
        for k in range(p):
            acc = pkg_add.add_rows_batched_wave(
                bank, lay, masks[k], offset=k, n_zero_adds=zeros,
                acc_val=acc, write_bits=False)
        pkg_add.write_accumulator_wave(bank, lay, acc)
        sub = acc[:, :2]
        pkg_add.write_accumulator_wave(bank, lay, sub[0] + 1,
                                       tiles=np.array([2, 0]))
        out[pkg_dev] = (_bits(acc), _bits(bank.data), bank.counts_matrix())
    for a, b in zip(out[t_dev], out[j_dev]):
        np.testing.assert_array_equal(a, b)


def test_bankarray_batched_ledger_lane_mask_and_shared_rows(rng):
    """Resident rows stay (tiles, rows, cols) — loaded once — while the
    ledger splits per (request, tile); a lane mask zeroes masked lanes'
    views; `charge_counts` on a tile subset; both packages equal."""
    tiles, B, cols = 3, 2, 8
    views = []
    for pkg in (j_dev, t_dev):
        bank = pkg.BankArray(tiles, rows=16, cols=cols, batch=B)
        assert tuple(bank.data.shape) == (tiles, 16, cols)
        bank.host_write_row(0, np.ones(cols, np.uint8))
        bank.row_copy(0, 1)
        n_adds = np.zeros((B, tiles), np.int64)
        n_adds[1, 2] = 4
        bank.charge_adds(pkg.OpCounts(row_copy=10, maj3=2, maj5=2), n_adds)
        bank.charge_host_int_ops(np.arange(tiles))
        bank.charge_counts(np.ones((B, 2, 7), np.int64), tiles=[2, 0])
        bank.charge_host_read([0, 1, 2])
        full = bank.counts_matrix()
        bank.lane_mask = np.array([False, True])
        views.append((full, bank.counts_matrix(), bank.tile_counts()))
    jv, tv = views
    np.testing.assert_array_equal(tv[0], jv[0])
    np.testing.assert_array_equal(tv[1], jv[1])
    assert _c(tv[2]) == _c(jv[2])
    assert tv[0][1, 2, 0] == 1 + 40 + 1 and not tv[1][0].any()
    bank = t_dev.BankArray(tiles, rows=16, cols=cols)
    with pytest.raises(ValueError, match="lane_mask requires"):
        bank.set_batch(None, lane_mask=np.ones(2, bool))
    with pytest.raises(ValueError, match="does not match"):
        bank.set_batch(2, lane_mask=np.ones(3, bool))


def test_majx_rejects_even_rows_and_write_shapes():
    sa = t_dev.Subarray(rows=16, cols=8)
    with pytest.raises(ValueError, match="odd row count"):
        sa.majx([0, 1])
    ba = t_dev.BankArray(tiles=2, rows=16, cols=8)
    with pytest.raises(ValueError, match="odd row count"):
        ba.majx([0, 1, 2, 3])
    with pytest.raises(ValueError, match=r"\(8,\)"):
        sa.host_write_row(0, np.zeros(5, dtype=np.uint8))
    with pytest.raises(ValueError, match=r"\(8,\)"):
        ba.host_write_row(0, np.zeros((2, 8), dtype=np.uint8))
    with pytest.raises(ValueError, match=r"\(2, 3, 8\)"):
        ba.host_write_rows([0, 1, 2], np.zeros((2, 2, 8), dtype=np.uint8))


def test_majx_fault_injection_matches_jax(rng):
    """A session on a Subarray and a BankArray: the same flips, on
    reliable columns only, per tile's (channel, bank) key."""
    rel = rng.random(64) > 0.2
    start = rng.integers(0, 2, size=(3, 8, 64)).astype(np.uint8)
    model = dict(transient_ber=0.2, weak_cell_rate=0.05, seed=3)
    got = []
    for pkg, fm in ((j_dev, JFaultModel), (t_dev, TFaultModel)):
        sa = pkg.Subarray(rows=8, cols=64, reliable_cols=rel)
        sa.data[:] = start[0] if pkg is j_dev else torch.from_numpy(start[0])
        sa.fault_session = fm(**model).session()
        sa.fault_key = (1, 2)
        sa.majx([0, 1, 2])
        ba = pkg.BankArray(3, rows=8, cols=64, reliable_cols=rel)
        ba.data[:] = start if pkg is j_dev else torch.from_numpy(start)
        ba.fault_session = fm(**model).session()
        ba.fault_keys = np.array([[0, 0], [0, 1], [1, 3]])
        ba.majx([3, 4, 5, 6, 7])
        got.append((_bits(sa.data).copy(), _bits(ba.data).copy(),
                    ba.fault_session.stats()))
    np.testing.assert_array_equal(got[1][0], got[0][0])
    np.testing.assert_array_equal(got[1][1], got[0][1])
    assert got[1][2] == got[0][2]
    clean = t_dev.Subarray(rows=8, cols=64, reliable_cols=rel)
    clean.data[:] = torch.from_numpy(start[0])
    clean.majx([0, 1, 2])
    flipped = got[1][0][0] != _bits(clean.data[0])
    assert flipped.any() and not (flipped & ~rel).any()
