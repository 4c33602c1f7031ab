"""perf/viterbi_sweep.py on a tiny width, the kernel interpreted."""
from ieee80211_phy.ops import coding
from ieee80211_phy.ops.pallas import viterbi as V
from ieee80211_phy.perf import viterbi_sweep as S
from ieee80211_phy.specs import CR


def test_viterbi_sweep_checks_every_variant(monkeypatch):
    """Every radix and (BLOCK, UNROLL) variant decodes exactly, and the
    module constants are restored afterwards."""
    monkeypatch.setattr(S, "N_XLA", 1)
    monkeypatch.setattr(S, "N_KERNEL", 1)
    rows = list(S.sweep(widths=[("tiny", 3, 24, CR.CR12)], rounds=1,
                        interpret=True))
    assert [r["variant"] for r in rows] == (
        [f"xla_r{k}" for k in S.RADICES]
        + [f"kernel_b{b}_u{u}" for b, u in S.KERNELS])
    assert all(r["median_s"] > 0 for r in rows)
    assert (V.BLOCK, V.UNROLL, coding.XLA_RADIX) == (32, 4, 3)
