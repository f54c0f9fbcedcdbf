"""Every table of the port's go_mp3_tpu_torch/ops/tables.py equals its
go_mp3_tpu counterpart bit for bit (same dtype, shape and bytes)."""

import numpy as np
import pytest

pytest.importorskip("torch")

import go_mp3_tpu.ops.granule as G  # noqa: E402
from go_mp3_tpu.ops import tables as J  # noqa: E402
from go_mp3_tpu_torch.ops import tables as P  # noqa: E402

NAMES = [
    "PRETAB", "IS_RATIO_L", "IS_RATIO_R", "INV_SQRT2", "CS", "CA",
    "IMDCT_WIN", "COS_N12", "COS_N36", "SYNTH_N_WIN", "SYNTH_DTBL",
    "FREQ_INV_SIGN", "LONG_SFB_OF_LINE", "SHORT_SFB_OF_LINE",
    "SHORT_WIN_OF_LINE", "REORDER_PERM_SHORT", "REORDER_PERM_MIXED",
    "LONG_BAND_START", "SHORT_BAND_START3", "REQ_SHORT_SFB_OF_LINE",
    "REQ_SHORT_WIN_OF_LINE", "N_BAND_VARIANTS", "CLASS_LONG", "CLASS_SHORT",
    "CLASS_MIXED",
]


def _assert_bit_identical(a, b) -> None:
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("name", NAMES)
def test_table_bit_identical(name):
    _assert_bit_identical(getattr(P, name), getattr(J, name))


def test_pow43_table_extends_jax_table():
    n = len(J.POW_4_3_F32)
    _assert_bit_identical(P.POW_4_3_INT16[:n], J.POW_4_3_F32)
    assert len(P.POW_4_3_INT16) == 32768


def test_pow2_quarter_table_exact_on_integer_exponents():
    q = np.arange(P.POW2_QMIN, P.POW2_QMIN + len(P.POW2_QUARTER))
    on_int = q % 4 == 0
    np.testing.assert_array_equal(
        P.POW2_QUARTER[on_int], np.ldexp(np.float32(1), q[on_int] // 4)
    )


def test_short_m3_bit_identical():
    _assert_bit_identical(P.SHORT_M3, G._SHORT_M3_NP)


def test_block_class_matches():
    for args in np.ndindex(2, 4, 2):
        assert P.block_class(*args) == J.block_class(*args)


def test_band_maps_cover_every_line():
    """Each line has one long band and one short (band, window) slot, the
    property that lets the port index the maps where JAX used the one-hot
    expansion matrices."""
    for v in range(P.N_BAND_VARIANTS):
        e_long = np.zeros((22, 576))
        e_long[P.LONG_SFB_OF_LINE[v], np.arange(576)] = 1
        np.testing.assert_array_equal(e_long, J.E_LONG[v * 22 : (v + 1) * 22])
        req = P.REQ_SHORT_SFB_OF_LINE[v] * 3 + P.REQ_SHORT_WIN_OF_LINE[v]
        e_short = np.zeros((39, 576))
        e_short[req, np.arange(576)] = 1
        np.testing.assert_array_equal(e_short, J.E_SHORT[v * 39 : (v + 1) * 39])
        isv = P.SHORT_SFB_OF_LINE[v] * 3 + P.SHORT_WIN_OF_LINE[v]
        e_is = np.zeros((39, 576))
        e_is[isv, np.arange(576)] = 1
        np.testing.assert_array_equal(e_is, J.E_SHORT_IS[v * 39 : (v + 1) * 39])
