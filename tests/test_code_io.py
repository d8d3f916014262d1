"""Standard-table interop (ops/code_io.py): alist and QC .npz loaders,
structural validation, and the golden end-to-end — a FILE-loaded foreign
table decoding through the full burst link."""

import numpy as np
import pytest

from aether_primitives_tpu.ops import code_io, ldpc


@pytest.fixture(scope="module")
def wifi_h():
    h, _, _ = ldpc.wifi_ldpc()
    return h


# ----------------------------------------------------------- alist format


def test_alist_roundtrip_bit_exact(tmp_path, wifi_h):
    p = tmp_path / "wifi.alist"
    code_io.save_alist(wifi_h, p)
    h2 = code_io.load_alist(p)
    assert np.array_equal(h2, wifi_h)


def test_alist_small_known_matrix(tmp_path):
    # hand-checkable 3x6: H rows = {0,1,2}, {2,3,4}, {4,5,0}
    h = np.zeros((3, 6), np.uint8)
    h[0, [0, 1, 2]] = 1
    h[1, [2, 3, 4]] = 1
    h[2, [4, 5, 0]] = 1
    p = tmp_path / "small.alist"
    code_io.save_alist(h, p)
    text = p.read_text().split("\n")
    assert text[0] == "6 3"           # n m
    assert text[1] == "2 3"           # max col deg, max row deg
    assert np.array_equal(code_io.load_alist(p), h)


def test_alist_truncated_rejected(tmp_path, wifi_h):
    p = tmp_path / "trunc.alist"
    code_io.save_alist(wifi_h, p)
    lines = p.read_text().strip().split("\n")
    p.write_text("\n".join(lines[: len(lines) // 2]))
    with pytest.raises(ValueError, match="truncated"):
        code_io.load_alist(p)


def test_alist_inconsistent_row_lists_rejected(tmp_path):
    h = np.zeros((3, 6), np.uint8)
    h[0, [0, 1, 2]] = 1
    h[1, [2, 3, 4]] = 1
    h[2, [4, 5, 0]] = 1
    p = tmp_path / "bad.alist"
    code_io.save_alist(h, p)
    lines = p.read_text().strip().split("\n")
    # corrupt the LAST row-adjacency line (swap a variable index) while
    # leaving the column lists intact — the cross-check must catch it
    lines[-1] = "2 5 6"
    p.write_text("\n".join(lines) + "\n")
    with pytest.raises(ValueError, match="disagrees"):
        code_io.load_alist(p)


def test_alist_degree_mismatch_rejected(tmp_path):
    p = tmp_path / "deg.alist"
    # declares col degree 2 but lists only one check for column 1
    p.write_text("2 2\n2 2\n2 1\n2 1\n1 0\n1 2\n1 2\n2 0\n")
    with pytest.raises(ValueError, match="degree|lists"):
        code_io.load_alist(p)


# ------------------------------------------------------------- QC .npz


def test_qc_npz_roundtrip_expands_to_wifi(tmp_path, wifi_h):
    p = tmp_path / "wifi_qc.npz"
    code_io.save_qc_npz(ldpc._WIFI_648_R12, 27, p)
    base, z = code_io.load_qc_npz(p)
    assert z == 27
    assert np.array_equal(base, ldpc._WIFI_648_R12)
    assert np.array_equal(ldpc.qc_expand(base, z), wifi_h)


def test_qc_npz_bad_shift_rejected(tmp_path):
    p = tmp_path / "bad_qc.npz"
    np.savez(p, base=np.array([[27, -1], [0, 3]], np.int64), z=np.int64(27))
    with pytest.raises(ValueError, match="shifts"):
        code_io.load_qc_npz(p)


def test_qc_npz_missing_keys_rejected(tmp_path):
    p = tmp_path / "nokeys.npz"
    np.savez(p, h=np.eye(3, dtype=np.int64))
    with pytest.raises(ValueError, match="base"):
        code_io.load_qc_npz(p)


# ------------------------------------------------------------ validation


def test_validate_wifi_report(wifi_h):
    rep = code_io.validate_parity_check(wifi_h, expect_k=324)
    assert (rep.n, rep.m, rep.rank, rep.k) == (648, 324, 324, 324)
    assert rep.rate == pytest.approx(0.5)
    # the 802.11n QC construction is 4-cycle free
    assert not rep.has_girth_4
    assert "girth >= 6" in rep.summary()


def test_validate_detects_girth_4():
    h = np.zeros((3, 6), np.uint8)
    h[0, [0, 1, 2]] = 1
    h[1, [0, 1, 3]] = 1  # shares vars {0, 1} with row 0 -> 4-cycle
    h[2, [3, 4, 5]] = 1
    rep = code_io.validate_parity_check(h)
    assert rep.has_girth_4 and "girth 4" in rep.girth_report


def test_validate_rejects_unprotected_column():
    h = np.zeros((2, 4), np.uint8)
    h[0, [0, 1]] = 1
    h[1, [1, 2]] = 1  # column 3 never checked
    with pytest.raises(ValueError, match="unprotected"):
        code_io.validate_parity_check(h)


def test_validate_rank_mismatch_rejected(wifi_h):
    with pytest.raises(ValueError, match="rank"):
        code_io.validate_parity_check(wifi_h, expect_k=300)


# --------------------------------------------- golden end-to-end (burst link)


def test_ldpc_from_alist_through_packet_modem(tmp_path, rng):
    """A synthetic alist file decodes through the FULL burst link:
    file -> validate -> generator -> PacketModem tx/rx with delay + noise."""
    from aether_primitives_tpu.models.packet import PacketConfig, PacketModem

    h, _, _ = ldpc.make_regular_ldpc(648, 3, 6, seed=11)
    p = tmp_path / "foreign.alist"
    code_io.save_alist(h, p)

    pm = PacketModem(PacketConfig(payload_bits=280, fec="ldpc",
                                  ldpc_file=str(p)))
    payload = rng.integers(0, 2, 280).astype(np.uint8)
    burst = np.asarray(pm.tx(payload))
    cap = np.zeros(burst.size + 150, np.complex64)
    cap[97 : 97 + burst.size] = burst
    cap += 0.05 * (rng.normal(size=cap.shape)
                   + 1j * rng.normal(size=cap.shape))
    bits, ok, _diag = pm.rx(cap.astype(np.complex64))
    assert bool(ok) and np.array_equal(np.asarray(bits), payload)


def test_ldpc_from_qc_npz_through_packet_modem(tmp_path, rng):
    """A QC .npz table (the 802.11n base) loads from file, engages the QC
    edge decoder, and decodes through the burst link."""
    from aether_primitives_tpu.models.packet import PacketConfig, PacketModem

    p = tmp_path / "wifi_qc.npz"
    code_io.save_qc_npz(ldpc._WIFI_648_R12, 27, p)
    pm = PacketModem(PacketConfig(payload_bits=280, fec="ldpc",
                                  ldpc_file=str(p)))
    assert pm._ldpc_qc is not None  # fast path engaged
    payload = rng.integers(0, 2, 280).astype(np.uint8)
    burst = np.asarray(pm.tx(payload))
    cap = np.zeros(burst.size + 80, np.complex64)
    cap[33 : 33 + burst.size] = burst
    cap += 0.05 * (rng.normal(size=cap.shape)
                   + 1j * rng.normal(size=cap.shape))
    bits, ok, _ = pm.rx(cap.astype(np.complex64))
    assert bool(ok) and np.array_equal(np.asarray(bits), payload)


def test_nr_base_graph_from_file_through_packet_modem(tmp_path, rng):
    """An .npz base graph drops into NrLdpc via nr_base_graph_file — the
    tested path for TS 38.212 tables arriving as files."""
    from aether_primitives_tpu.models.packet import PacketConfig, PacketModem
    from aether_primitives_tpu.ops.nr_ldpc import make_nr_base_graph

    base = make_nr_base_graph(bg=2, z=64, seed=99)
    p = tmp_path / "bg2.npz"
    code_io.save_qc_npz(base, 64, p)

    pm = PacketModem(PacketConfig(payload_bits=500, fec="nr_ldpc",
                                  nr_base_graph_file=str(p)))
    # the file-loaded graph (seed 99) actually replaced the default (seed 1)
    assert pm._nr.base_graph == tuple(
        map(tuple, np.where(base >= 0, base % pm._nr.z, -1).tolist())
    )
    payload = rng.integers(0, 2, 500).astype(np.uint8)
    bits, ok, _ = pm.loopback(payload)
    assert bool(ok) and np.array_equal(np.asarray(bits), payload)


def test_ldpc_from_file_triple_contract(tmp_path):
    h, _, _ = ldpc.make_regular_ldpc(648, 3, 6, seed=13)
    p = tmp_path / "c.alist"
    code_io.save_alist(h, p)
    h2, g, info = code_io.ldpc_from_file(p)
    assert np.array_equal(h2, h)
    assert ((g @ h.T) % 2 == 0).all()
    k = g.shape[0]
    assert info.size == k and np.unique(info).size == k
    # systematic up to permutation: message bits land at info positions
    msg = np.arange(k) % 2
    cw = (msg @ g) % 2
    assert np.array_equal(cw[info], msg)
