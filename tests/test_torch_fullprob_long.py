"""The full-probability slice on a pair past the lane builds: the port's
CLI with --device cpu on a 5,000 bp pair (a sequence and a copy with
10% of its sites redrawn and 1-3 sites lost or gained after 1% of them,
tools/bench_fullprob.py's redrawn_pair with indels 0.01, whose linear
fills take kernels D's and E's cluster build on a card) must write the
JAX CLI's bytes for --full-probability and for --sample-path --seed 7.
The two outputs differ (16 of 5,047 columns): the sampled path is drawn
from the forward planes, and the posterior-annotated path is Viterbi's.

The pinned sha256 are the JAX CLI's output on the same files, run once
on the CPU as tests/test_torch_fullprob_cli.py's REFERENCE_FP runs it
(f32, JAX_ENABLE_X64=0, every Pallas module in interpret mode; about
three minutes a run). chip_smoke.py's fullprob_long_path holds the
card's output to the same hashes."""
import hashlib

import pytest

from pagan2_tpu_torch import cli
from pagan2_tpu_torch.align import fullprob_fill as ff
from pagan2_tpu_torch.tools.bench_fullprob import redrawn_pair

# sha256 of the JAX CLI's out.fas, by mode
JAX_SHA = {
    "full_probability": ("918197e66244fbb1cc600cb569b52b77"
                         "e4a3f193e073d91c2a41df2514e4e9b8"),
    "sample_path": ("79bf57f982345aca93e91cf16bdae4b9"
                    "47a30fae6aa6bbcb9af685953ab4b150"),
}
MODES = {"full_probability": ["--full-probability"],
         "sample_path": ["--sample-path", "--seed", "7"]}


@pytest.mark.parametrize("mode", list(MODES))
def test_long_pair_writes_the_reference_bytes(tmp_path, monkeypatch, mode):
    a, b = redrawn_pair(5000, indels=0.01)
    (tmp_path / "pair.fas").write_text(">a\n%s\n>b\n%s\n" % (a, b))
    (tmp_path / "pair.nh").write_text("(a:0.1,b:0.1);\n")
    lanes = []
    real = ff.fullprob_fwd

    def fwd(**kw):
        lanes.append(kw["ms2"].shape[2])
        return real(**kw)
    monkeypatch.setattr(ff, "fullprob_fwd", fwd)
    n0 = ff.PLAIN_CALLS["fullprob_bwd"]
    assert cli.main(["--device", "cpu", "--silent",
                     "-s", str(tmp_path / "pair.fas"),
                     "-t", str(tmp_path / "pair.nh"),
                     "-o", str(tmp_path / "out")] + MODES[mode]) == 0
    got = hashlib.sha256((tmp_path / "out.fas").read_bytes()).hexdigest()
    assert got == JAX_SHA[mode]
    # one linear batch, past the lane builds: the cluster build's plan
    assert len(lanes) == 1 and ff.PLAIN_CALLS["fullprob_bwd"] == n0 + 1
    assert lanes[0] >= ff.CLUSTER_FROM
    assert ff.fwd_linear_plan(lanes[0])["cluster"] >= 2
    assert ff.bwd_linear_plan(lanes[0])["cluster"] >= 2
