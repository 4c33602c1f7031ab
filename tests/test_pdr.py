"""Smoke test of the PDR sweep harness: curves behave physically."""
import numpy as np

from ieee80211_phy.perf import pdr_sweep
from ieee80211_phy.specs import F


def test_pdr_curve_shape():
    curves = pdr_sweep(F.L, mcs_list=[0, 7], snr_db=[-2.0, 12.0, 30.0],
                       n_pkt=20, payload_len=100)
    # MCS0 at 12 dB and 30 dB: essentially perfect
    assert curves[0][1] > 0.9 and curves[0][2] > 0.9
    # MCS7 (64QAM 3/4) at -2 dB: dead; at 30 dB: perfect
    assert curves[7][0] < 0.2
    assert curves[7][2] > 0.9
    # monotone-ish
    assert curves[7][2] >= curves[7][0]
