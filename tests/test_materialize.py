"""Materialization (fsm._materialize_events) == NumPy truth, bit for bit.

The compact + spread butterfly networks must place exactly the
coefficients a direct NumPy placement would, for any event matrix that
satisfies the FSM's emission contract: per lane, valid events appear in
row order with strictly increasing targets.  The shapes cover N < M,
N > M (spread truncation), window-straddling sizes and decode-realistic
per-block event counts, dense groups included.  materialize_checked's
optional checksum is pinned both ways.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from tpujpeg.ops import fsm


def _random_events(rng, n_rows, max_blk, L, density):
    """Packed event matrix honoring the per-lane ordering contract."""
    M = max_blk * 64
    ev = np.full((n_rows, L), -1, np.int32)
    want = np.zeros((M, L), np.int32)
    for lane in range(L):
        k = min(int(rng.binomial(n_rows, density)), M, n_rows)
        rows = np.sort(rng.choice(n_rows, size=k, replace=False))
        targets = np.sort(rng.choice(M, size=k, replace=False))
        vals = rng.integers(1, 2047, k) * rng.choice([-1, 1], k)
        for r, t, v in zip(rows, targets, vals):
            blk, z = divmod(int(t), 64)
            ev[r, lane] = (blk << 18) | (z << 12) | (int(v) + 2048)
            want[t, lane] = v
    return ev, want


def _block_events(rng, n_rows, max_blk, L, mean_ev, heavy=()):
    """Decode-realistic events: per block, a random set of distinct
    ascending zigzag positions (the FSM emission contract).  `heavy`
    lanes get their first 8 blocks completely full (64 events each)."""
    ev = np.full((n_rows, L), -1, np.int32)
    want = np.zeros((max_blk * 64, L), np.int32)
    for lane in range(L):
        rows = []
        for b in range(max_blk):
            n = min(64, int(rng.poisson(mean_ev)))
            if lane in heavy and b < 8:
                n = 64
            for z in np.sort(rng.choice(64, n, replace=False)):
                v = int(rng.integers(1, 2047)) * (1 if rng.random() < .5
                                                  else -1)
                rows.append((b, int(z), v))
                want[b * 64 + z, lane] = v
        assert len(rows) <= n_rows
        pos = np.sort(rng.choice(n_rows, len(rows), replace=False))
        for p, (b, z, v) in zip(pos, rows):
            ev[p, lane] = (b << 18) | (z << 12) | (v + 2048)
    return ev, want


def _place(ev, M):
    return np.asarray(fsm._materialize_events(jnp.asarray(ev), M))


@pytest.mark.parametrize("density", [0.0, 0.15, 0.6])
def test_materialize_matches_truth(density):
    rng = np.random.default_rng(int(density * 100) + 1)
    n_rows, max_blk, L = 96, 2, 128
    ev, want = _random_events(rng, n_rows, max_blk, L, density)
    np.testing.assert_array_equal(_place(ev, max_blk * 64), want)


def test_materialize_taller_than_M():
    # N > M exercises the truncation branch of the spread
    rng = np.random.default_rng(7)
    n_rows, max_blk, L = 192, 2, 128
    ev, want = _random_events(rng, n_rows, max_blk, L, 0.3)
    np.testing.assert_array_equal(_place(ev, max_blk * 64), want)


@pytest.mark.parametrize(
    "n_rows,max_blk",
    [(2304, 64), (2500, 35), (700, 47), (4000, 33), (4000, 80)],
)
def test_materialize_shapes(n_rows, max_blk):
    # N and M on both sides of powers of two, N > M and N < M, with a
    # fully-empty lane
    rng = np.random.default_rng(n_rows + max_blk)
    L = 128
    ev, want = _random_events(rng, n_rows, max_blk, L, 0.25)
    ev[:, 0] = -1
    want[:, 0] = 0
    np.testing.assert_array_equal(_place(ev, max_blk * 64), want)


@pytest.mark.parametrize("n_rows,max_blk,mean_ev", [
    (2600, 60, 20),     # photo-density blocks
    (2100, 33, 4),      # sparse
    (4200, 120, 26),    # dense, N > rank space
    (2600, 60, 8),
    (2100, 120, 3),     # short scan, tall block space: targets >> ranks
])
def test_materialize_block_events(n_rows, max_blk, mean_ev):
    rng = np.random.default_rng(n_rows + max_blk + mean_ev)
    ev, want = _block_events(rng, n_rows, max_blk, 128, mean_ev)
    np.testing.assert_array_equal(_place(ev, max_blk * 64), want)


def test_materialize_full_blocks_exact():
    # lanes whose leading blocks carry all 64 coefficients each: no
    # capacity limit anywhere, every lane bit-exact
    rng = np.random.default_rng(7)
    ev, want = _block_events(rng, 2600, 60, 128, 10, heavy=(3, 77))
    np.testing.assert_array_equal(_place(ev, 60 * 64), want)


def test_materialize_checked_off_by_default(monkeypatch):
    monkeypatch.delenv("TPUJPEG_SELFCHECK", raising=False)
    rng = np.random.default_rng(3)
    ev, want = _random_events(rng, 96, 2, 128, 0.2)
    err = jnp.zeros(128, bool)
    dense, err_out = fsm.materialize_checked(jnp.asarray(ev), 128, err)
    np.testing.assert_array_equal(np.asarray(dense), want)
    assert not np.asarray(err_out).any()


def test_materialize_checked_latches_lost_event(monkeypatch):
    # with the checksum on, an event whose target lies past M cannot land
    # in the dense tensor: exactly its lane latches err_mal
    monkeypatch.setenv("TPUJPEG_SELFCHECK", "1")
    rng = np.random.default_rng(4)
    ev, want = _random_events(rng, 96, 2, 128, 0.2)
    ev[95, 5] = (3 << 18) | (1 << 12) | (7 + 2048)   # block 3 >= max_blk
    err = jnp.zeros(128, bool)
    dense, err_out = fsm.materialize_checked(jnp.asarray(ev), 128, err)
    err_out = np.asarray(err_out)
    assert err_out[5] and err_out.sum() == 1
    keep = np.arange(128) != 5
    np.testing.assert_array_equal(np.asarray(dense)[:, keep], want[:, keep])


@pytest.mark.parametrize("value,on", [("1", True), ("0", False),
                                      ("auto", False), (None, False)])
def test_selfcheck_switch(monkeypatch, value, on):
    if value is None:
        monkeypatch.delenv("TPUJPEG_SELFCHECK", raising=False)
    else:
        monkeypatch.setenv("TPUJPEG_SELFCHECK", value)
    assert fsm._selfcheck_enabled() is on
