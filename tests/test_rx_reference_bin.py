"""Cross-implementation replay: decode the reference's checked-in capture.

SURVEY.md §4.2: the reference ships pre-generated waveform bins
(tools/sig80211GenMultipleSiso_1x1_0.bin) used to drive its C++ RX; our
receiver must recover the exact MPDU the reference self-test expects
(tools/pktRxExample.py:824).
"""
import os

import pytest

from ieee80211_phy.rx import SisoReceiver
from ieee80211_phy.specs import F
from ieee80211_phy.utils import load_complex_bin

BIN = "/root/reference/tools/sig80211GenMultipleSiso_1x1_0.bin"

KNOWN_MPDU = (b'\x08\x01n\x00\xf4i\xd5\x80\x0f\xa0\x00\xc0\xca\xb1[\xe1\xf4i'
              b'\xd5\x80\x0f\xa0\x00\xa9\xaa\xaa\x03\x00\x00\x00\x08\x00E\x00'
              b'\x00:\xab\x02@\x00@\x11{\x96\n\n\x00\x06\n\n\x00\x01\x99\xd3"'
              b'\xb9\x00&\x10\xec123456789012345678901234567890\xa3]\xee\xec')


@pytest.mark.skipif(not os.path.exists(BIN), reason="reference bin missing")
def test_decode_reference_siso_bin():
    cap = load_complex_bin(BIN)
    res = SisoReceiver().decode_capture(cap)
    assert len(res) == 1
    r = res[0]
    assert r.fmt == F.L and r.mcs == 0
    assert r.fcs_ok
    assert r.mpdus[0] == KNOWN_MPDU


BIN_MIMO = "/root/reference/tools/sig80211GenMultipleMimo_2x2_{}.bin"


@pytest.mark.skipif(not os.path.exists(BIN_MIMO.format(0)),
                    reason="reference bins missing")
def test_decode_reference_mimo_bins():
    """Cross-implementation 2x2 replay: the reference generates these bins
    with PY-TB (tools/pktGenExample.py:217-231: HT MCS8 nSTS=2, the same
    30-byte UDP payload as the SISO bin) and replays them through its C++
    2x2 RX (examples/rx2.grc). Our MimoReceiver must recover the exact
    MPDU — independent evidence for the MIMO path, not just our-TX->our-RX
    loopback."""
    import numpy as np

    from ieee80211_phy.rx.mimo import MimoReceiver

    cap = np.stack([load_complex_bin(BIN_MIMO.format(c)) for c in range(2)])
    res = MimoReceiver().decode_capture(cap)
    assert len(res) == 1
    r = res[0]
    assert r.fmt == F.HT and r.mcs == 8
    assert r.fcs_ok
    assert r.mpdus[0] == KNOWN_MPDU
