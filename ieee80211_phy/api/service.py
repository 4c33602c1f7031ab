"""The PHY service: request -> waveform (TX) and capture -> records (RX).

This is the framework's replacement for the reference's GNU Radio flowgraphs
plus socket_pdu endpoints (examples/tx.grc + rx.grc + MAC UDP API,
SURVEY.md §1 L2/L3): a single object that accepts the binary MAC->PHY
requests, synthesizes waveforms, and decodes captures back into the binary
PHY->MAC records — in-process, or served over the same UDP port pair as the
reference (TX 9528 / RX 9527).
"""
from __future__ import annotations

import socket
import threading
from typing import Callable, List, Optional

import numpy as np

from ..rx import SisoReceiver
from ..rx.mimo import MimoReceiver
from ..specs import BW, F, GRF, Mod
from ..tx import finalize, gen_ampdu, gen_ampdu_mu, gen_mpdu
from . import descriptors as d


class PhyService:
    """In-process PHY endpoint with the reference's wire API.

    mupos/mugid configure the station's MU-MIMO group position for downlink
    MU decode (parity: demod block parameters, grc/ieee80211_demod.block.yml).
    """

    def __init__(self, mupos: int = 0, mugid: int = 1, amplitude: float = 0.25,
                 gap_len: int = 1200):
        self.mupos = mupos
        self.mugid = mugid
        self.amplitude = amplitude
        self.gap_len = gap_len
        self.bfq: Optional[np.ndarray] = None
        # mugid in [1, 62] arms the receivers' integrated streaming MU-STA
        # path (rx/receiver._plan_mu_batch -> MuStaDataDecoder lanes);
        # mugid 0 (an AP / non-group member) disables it
        gid = mugid if 1 <= mugid <= 62 else None
        self.siso_rx = SisoReceiver(mu_pos=mupos, mu_gid=gid)
        self.mimo_rx = MimoReceiver(mu_pos=mupos, mu_gid=gid)

    # -- TX side -----------------------------------------------------------
    def handle_request(self, msg: bytes) -> Optional[np.ndarray]:
        """Binary request -> waveform [nSS, N] complex64 (None for BFQ)."""
        req = d.unpack_request(msg)
        if req is None:
            return None
        if isinstance(req, d.BfqMessage):
            self.bfq = req.q            # installed for subsequent MU packets
            return None
        if isinstance(req, d.NdpRequest):
            tx = gen_ampdu(b"", Mod(F.VHT, 0, BW.BW20, req.n_sts))
            return finalize(tx.waveform, multiplier=self.amplitude,
                            gap=True, gap_len=self.gap_len)
        if isinstance(req, d.MuDataRequest):
            assert self.bfq is not None, "BFQ must be installed before MU TX"
            n_sts = req.n_sts0 + req.n_sts1
            assert self.bfq.shape[1] == n_sts, (
                f"installed BFQ is {self.bfq.shape[1]}-stream but the MU "
                f"request totals {n_sts} streams")
            tx = gen_ampdu_mu(
                [req.mpdu0, req.mpdu1],
                [Mod(F.VHT, req.mcs0, BW.BW20, req.n_sts0),
                 Mod(F.VHT, req.mcs1, BW.BW20, req.n_sts1)],
                bfq=self.bfq, group_id=req.group_id)
            return finalize(tx.waveform, multiplier=self.amplitude,
                            gap=True, gap_len=self.gap_len)
        mod = Mod(req.fmt, req.mcs, BW.BW20, req.n_sts)
        if req.fmt == F.VHT:
            tx = gen_ampdu(req.mpdu, mod)
        else:
            tx = gen_mpdu(req.mpdu, mod)
        return finalize(tx.waveform, multiplier=self.amplitude,
                        gap=True, gap_len=self.gap_len)

    # -- RX side -----------------------------------------------------------
    def rx_capture(self, capture: np.ndarray) -> List[bytes]:
        """Decode a capture into binary PHY->MAC records.

        capture: [N] (SISO) or [2, N] (dual-chain). Emits data records for
        every FCS-valid MPDU, NDP channel reports, and — when this service
        is configured with a MU group — this station's MU stream.
        """
        records: List[bytes] = []
        capture = np.asarray(capture)
        if capture.ndim == 2:
            # universal dual-chain pass: legacy/SISO (MRC), 2x2, and NDP
            # channel reports — one per RX chain (the reference emits one
            # type-20 blob per NDP from its data chain,
            # lib/decode_impl.cc:100-121; a 2-chain report doubles the
            # sounding information)
            pkts2, ndps2 = self.mimo_rx.decode_capture_full(capture)
            for r in pkts2:
                for mpdu in r.mpdus:
                    records.append(d.pack_rx_record(r.fmt.value, mpdu, r.mcs))
            for chain_caps in ndps2:
                for ndp in chain_caps:
                    records.append(d.pack_channel_report(ndp.ltf_iq))
            return records
        # unified receiver pass: data packets, this STA's downlink MU
        # stream (when mugid is configured — batched MuStaDataDecoder
        # lanes inside the same dispatch) AND NDP channel reports come
        # from ONE decode (parity: lib/decode_impl.cc:100-121 emits the
        # type-20 blob from the same chain that emits data)
        pkts, ndps = self.siso_rx.decode_capture_full(capture)
        for r in pkts:
            for mpdu in r.mpdus:
                records.append(d.pack_rx_record(r.fmt.value, mpdu, r.mcs))
        for ndp in ndps:
            records.append(d.pack_channel_report(ndp.ltf_iq))
        return records

    def rx_captures(self, captures) -> List[List[bytes]]:
        """Sustained streaming decode: a LIST of captures through the
        pipelined `decode_captures` path (the reference's continuous
        20 Msps flowgraph operating point, examples/rx.grc) — per-capture
        record lists, with NDP channel reports surfaced inline.

        All captures must share a shape family: [N] (SISO) or [2, N]
        (dual-chain)."""
        caps = [np.asarray(c) for c in captures]
        if not caps:
            return []
        dual = caps[0].ndim == 2
        rx = self.mimo_rx if dual else self.siso_rx
        results, ndps = rx.decode_captures_full(caps)
        out: List[List[bytes]] = []
        for k, res_k in enumerate(results):
            recs: List[bytes] = []
            for r in res_k:
                for mpdu in r.mpdus:
                    recs.append(d.pack_rx_record(r.fmt.value, mpdu, r.mcs))
            for nd in ndps[k]:
                for ndp in (nd if isinstance(nd, list) else [nd]):
                    recs.append(d.pack_channel_report(ndp.ltf_iq))
            out.append(recs)
        return out

    # -- UDP mode (reference port pair) ------------------------------------
    def serve_udp(self, on_waveform: Callable[[np.ndarray], None],
                  tx_addr=("127.0.0.1", 9528), stop_event=None):
        """Listen for MAC requests on the reference TX port; synthesized
        waveforms go to `on_waveform` (e.g. a channel emulator or radio).
        A long-running server: compiled programs go to the persistent
        compile cache (utils/runtime.py)."""
        from ..utils.runtime import enable_compile_cache
        enable_compile_cache()
        sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        sock.bind(tx_addr)
        sock.settimeout(0.25)
        while stop_event is None or not stop_event.is_set():
            try:
                msg, _ = sock.recvfrom(65535)
            except socket.timeout:
                continue
            wave = self.handle_request(msg)
            if wave is not None:
                on_waveform(wave)
        sock.close()

    def send_records(self, records: List[bytes],
                     rx_addr=("127.0.0.1", 9527)):
        sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        for rec in records:
            sock.sendto(rec, rx_addr)
        sock.close()
