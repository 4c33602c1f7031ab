"""Generic MAC frame parser: frame control, mgmt elements, beacon round-trip.

Parity target: reference pktParser / mgmtElementParser
(/root/reference/tools/mac80211header.py:732-938) and the beacon waveform
example (/root/reference/tools/pktGenExample.py:233-240) — re-expressed as
structured parsing plus a synthesized (not replayed) beacon through the full
golden TX -> JAX RX chain.
"""
import struct

from ieee80211_phy.mac import (MacConfig, build_beacon, build_bf_report_poll,
                               build_element, build_udp_mpdu,
                               build_vht_ndp_announcement, parse_frame,
                               parse_mgmt_elements)
from ieee80211_phy.rx import SisoReceiver
from ieee80211_phy.specs import F, Mod
from ieee80211_phy.tx import finalize, gen_mpdu


def test_frame_control_decode():
    beacon = build_beacon("net", "00:c0:ca:b1:5b:e1", "00:c0:ca:b1:5b:e1")
    p = parse_frame(beacon)
    assert p.fc.ftype == 0 and p.fc.subtype == 8
    assert p.fc.type_name == "Management"
    assert p.fc.subtype_name == "Beacon"
    assert p.fcs_ok
    assert p.addr1 == "ff:ff:ff:ff:ff:ff"
    assert p.addr2 == "00:c0:ca:b1:5b:e1"


def test_beacon_fields_and_elements():
    beacon = build_beacon(
        "cloud_ac86u_5G", "24:4b:fe:61:25:ac", "24:4b:fe:61:25:ac",
        seq=671, timestamp=23784950, interval_tu=100, capability=0x1111,
        channel=100,
        extra_elements=[(7, b"US \x24\x01\x1e"),
                        (11, struct.pack("<HBH", 17, 42, 23700)),
                        (64, b"\x02"),
                        (195, b"\x02\x1e")])
    p = parse_frame(beacon)
    assert p.ssid == "cloud_ac86u_5G"
    assert p.timestamp == 23784950
    assert p.beacon_interval == 100
    assert p.capability == 0x1111
    assert p.seq == 671
    by_id = {e.eid: e for e in p.elements}
    assert by_id[3].fields["channel"] == 100
    assert by_id[7].fields["country"] == "US"
    assert by_id[11].fields == {"station_count": 17,
                                "channel_utilization": 42,
                                "avail_admission_capacity": 23700}
    assert by_id[64].fields["antenna"] == 2
    assert by_id[195].fields == {"pwr_count": 2, "max_pwr_20mhz": 30}
    # rate list: 6(B) 9 12 18 24 36 48 54 Mbps (the reference's defaults)
    rates = by_id[1].fields["rates_mbps"]
    assert rates[0] == (6.0, True) and rates[-1] == (54.0, False)
    # human-readable summary covers every element
    desc = "\n".join(p.describe())
    assert "SSID: cloud_ac86u_5G" in desc and "DS Channel: 100" in desc


def test_mgmt_element_walk_is_robust():
    # truncated trailing element must not be emitted or crash
    body = build_element(0, b"x") + b"\x01\x09\x8c"
    els = parse_mgmt_elements(body)
    assert len(els) == 1 and els[0].eid == 0


def test_ht_vht_cap_elements():
    ht = build_element(45, struct.pack("<H", 0b0110_0011) + b"\x00" +
                       bytes([0xFF, 0xFF, 0xFF, 0xFF] + [0] * 12) + b"\x00" * 9)
    vht = build_element(191, struct.pack("<I", (1) | (1 << 4) | (1 << 7) |
                                         (3 << 8) | (2 << 16)) + b"\x00" * 8)
    els = parse_mgmt_elements(ht + vht)
    hf, vf = els[0].fields, els[1].fields
    assert hf["ldpc"] == 1 and hf["chan_width"] == 1 and hf["sgi20"] == 1
    assert hf["rx_mcs_bitmap"][:32] == [1] * 32
    assert vf == {"max_mpdu_len": 1, "rx_ldpc": 1, "tx_stbc": 1,
                  "rx_stbc": 3, "sounding_dim": 2}


def test_control_frames_parse():
    ndpa = build_vht_ndp_announcement("ff:ff:ff:ff:ff:ff",
                                      "00:c0:ca:b1:5b:e1", token=3,
                                      sta_aids=[1, 2], sta_fb_type=[1, 1],
                                      sta_nc=[1, 1])
    p = parse_frame(ndpa)
    assert p.fc.ftype == 1 and p.fc.subtype_name == "VHT NDP Announcement"
    assert p.addr2 == "00:c0:ca:b1:5b:e1" and p.fcs_ok

    poll = build_bf_report_poll("f4:69:d5:80:0f:a0", "00:c0:ca:b1:5b:e1",
                                fb_segments=[0])
    p = parse_frame(poll)
    assert p.fc.subtype_name == "Beamforming Report Poll"
    assert p.body == b"\x01"


def test_data_frame_parse_matches_fast_path():
    cfg = MacConfig(subtype=8, addr1="f4:69:d5:80:0f:a0",
                    addr2="00:c0:ca:b1:5b:e1", addr3="f4:69:d5:80:0f:a0",
                    seq=2704, qos=5)
    mpdu = build_udp_mpdu(b"hello world", cfg)
    p = parse_frame(mpdu)
    assert p.fc.ftype == 2 and p.fc.subtype == 8 and p.fc.to_ds == 1
    assert p.qos_ctrl == 5 and p.seq == 2704 and p.fcs_ok
    assert p.addr2 == "00:c0:ca:b1:5b:e1"


def test_beacon_waveform_roundtrip():
    """Synthesized L-MCS0 beacon through golden TX -> JAX RX -> parser
    (the reference's beacon example replays a fixed capture; we generate,
    decode and parse one from scratch)."""
    beacon = build_beacon("cloud_phy_5G", "24:4b:fe:61:25:ac",
                          "24:4b:fe:61:25:ac", seq=7, timestamp=1234567,
                          capability=0x0411)
    tx = gen_mpdu(beacon, Mod(F.L, 0))
    cap = finalize(tx.waveform, multiplier=0.2, cfo_hz=23456.0, num=1,
                   gap=True, gap_len=1200)[0]
    res = SisoReceiver().decode_capture(cap)
    assert len(res) == 1 and res[0].fcs_ok
    assert res[0].mpdus[0] == beacon
    p = parse_frame(res[0].mpdus[0])
    assert p.fc.subtype_name == "Beacon" and p.ssid == "cloud_phy_5G"
    assert p.timestamp == 1234567 and p.fcs_ok
