"""ieee80211_phy — a batched IEEE 802.11a/g/n/ac PHY framework in JAX.

A from-scratch re-design of the capabilities of the GR-WiFi reference
(GNU Radio OOT module + Python toolbox) as batched, fused, sharded array
computation on NVIDIA GPUs via JAX/XLA/Pallas:

  * specs/     standard-derived tables + static PPDU descriptors
  * ops/       batched PHY ops (coding, mapping, OFDM, sync, chan-est)
  * tx/        full TX chain (L/HT/VHT, SISO/2x2 MIMO/MU-MIMO, A-MPDU, NDP)
  * rx/        full RX chain (trigger/sync/CFO/SIG/demod/Viterbi/FCS)
  * mac/       MAC frame build/parse (UDP/IPv4/LLC/802.11, A-MPDU, BF report)
  * mu/        MU-MIMO sounding: channel feedback, SVD, compression, ZF Q
  * parallel/  device-mesh sharding: batch DP + time-block halo + antenna axes
  * utils/     bin-file IO compatible with the reference formats
"""

__version__ = "0.1.0"
