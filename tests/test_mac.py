"""MAC frame builders byte-identical to the reference toolbox."""
import numpy as np
import pytest

from ieee80211_phy.mac import (MacConfig, aggregate_ht, aggregate_vht,
                               build_udp_mpdu, build_vht_ndp_announcement,
                               deaggregate_ht, deaggregate_vht, parse_mpdu,
                               parse_udp_mpdu)

from reference_oracle import get_oracle, quiet

CFG = MacConfig(ftype=2, subtype=0, to_ds=1, from_ds=0, retry=0, protected=0,
                addr1="f4:69:d5:80:0f:a0", addr2="00:c0:ca:b1:5b:e1",
                addr3="f4:69:d5:80:0f:a0", seq=2704)
CFG_QOS = MacConfig(ftype=2, subtype=8, to_ds=1, from_ds=0, retry=0,
                    protected=0, addr1="f4:69:d5:80:0f:a0",
                    addr2="00:c0:ca:b1:5b:e1", addr3="f4:69:d5:80:0f:a0",
                    seq=2704)


def _ref_mpdu(payload: bytes, subtype: int) -> bytes:
    mac = get_oracle("mac80211")
    with quiet():
        udp = mac.udp("10.10.0.6", "10.10.0.1", 39379, 8889)
        pkt = udp.genPacket(payload)
        ip = mac.ipv4(43778, 64, "10.10.0.6", "10.10.0.1")
        pkt = ip.genPacket(pkt)
        llc = mac.llc()
        pkt = llc.genPacket(pkt)
        m = mac.mac80211(2, subtype, 1, 0, 0, 0, "f4:69:d5:80:0f:a0",
                         "00:c0:ca:b1:5b:e1", "f4:69:d5:80:0f:a0", 2704)
        return m.genPacket(pkt)


def test_udp_mpdu_bytes():
    payload = b"123456789012345678901234567890"
    assert build_udp_mpdu(payload, CFG) == _ref_mpdu(payload, 0)
    assert build_udp_mpdu(payload, CFG_QOS) == _ref_mpdu(payload, 8)


def test_known_mpdu_hex():
    """The exact MPDU the reference self-test compares against
    (tools/pktRxExample.py:824)."""
    payload = b"123456789012345678901234567890"
    want = (b'\x08\x01n\x00\xf4i\xd5\x80\x0f\xa0\x00\xc0\xca\xb1[\xe1\xf4i'
            b'\xd5\x80\x0f\xa0\x00\xa9\xaa\xaa\x03\x00\x00\x00\x08\x00E\x00'
            b'\x00:\xab\x02@\x00@\x11{\x96\n\n\x00\x06\n\n\x00\x01\x99\xd3"'
            b'\xb9\x00&\x10\xec123456789012345678901234567890\xa3]\xee\xec')
    assert build_udp_mpdu(payload, CFG) == want


def test_ampdu_vht_bytes():
    mac = get_oracle("mac80211")
    p = build_udp_mpdu(b"x" * 30, CFG_QOS)
    with quiet():
        assert aggregate_vht([p]) == mac.genAmpduVHT([p])
        assert aggregate_vht([p, p, p]) == mac.genAmpduVHT([p, p, p])
        assert aggregate_ht([p]) == mac.genAmpduHT([p])
        assert aggregate_ht([p, p, p]) == mac.genAmpduHT([p, p, p])


def test_ampdu_roundtrip():
    frames = [build_udp_mpdu(bytes([i]) * (20 + i), CFG_QOS) for i in range(3)]
    subs = deaggregate_vht(aggregate_vht(frames))
    assert [s.mpdu for s in subs] == frames
    assert all(s.fcs_ok for s in subs)
    subs = deaggregate_ht(aggregate_ht(frames))
    assert [s.mpdu for s in subs] == frames
    assert all(s.fcs_ok for s in subs)


def test_parse_udp_roundtrip():
    payload = b"hello world payload"
    mpdu = build_udp_mpdu(payload, CFG)
    p = parse_mpdu(mpdu)
    assert p.fcs_ok and p.ftype == 2 and p.subtype == 0 and p.seq == 2704
    u = parse_udp_mpdu(mpdu)
    assert u.payload == payload and u.dst_port == 8889


def test_ndp_announcement():
    mac = get_oracle("mac80211")
    with quiet():
        m = mac.mac80211(2, 8, 1, 0, 0, 0, "f4:69:d5:80:0f:a0",
                         "00:c0:ca:b1:5b:e1", "f4:69:d5:80:0f:a0", 2704)
        want = m.genCtrlVhtNdpAnnouncement("6e:1b:72:2a:1c:b8",
                                           "00:27:e3:9d:e8:9c", 23,
                                           [100], [0], [0])
    got = build_vht_ndp_announcement("6e:1b:72:2a:1c:b8", "00:27:e3:9d:e8:9c",
                                     23, [100], [0], [0])
    assert got == want
