"""The port's device rule: entry points run on CUDA unless the caller
asks for the CPU, and raise (never fall back) when CUDA is asked for
without a card; kernel wrappers check their arguments before running
anything, on any device."""
import numpy as np
import pytest
import torch

from pagan2_tpu_torch.device import resolve_device
from pagan2_tpu_torch.align import viterbi_fanin as tf
from pagan2_tpu_torch.align import viterbi_linear as tl
from pagan2_tpu_torch.align.viterbi_sheared import prepare_sheared
from pagan2_tpu_torch.align import AlignSettings
from pagan2_tpu_torch.graph import build_leaf_graph
from pagan2_tpu_torch.models import ModelFactory, alphabets as alph
from pagan2_tpu_torch import cli

MODEL = ModelFactory(alph.DNA).alignment_model(0.2)


def _pair(**kw):
    return (build_leaf_graph("ACGTTGCAAGGCTTACGATCGA", alph.DNA, **kw),
            build_leaf_graph("ACGTTGCAGGCTTACGTTCGA", alph.DNA, **kw))


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_cuda_without_card_raises(monkeypatch):
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def test_cli_defaults_to_cuda_and_raises_without_it(monkeypatch, tmp_path):
    _no_cuda(monkeypatch)
    assert cli.build_parser().parse_args([]).device == "cuda"
    (tmp_path / "s.fas").write_text(">a\nACGTACGTTGCA\n>b\nACGTACTTGCA\n")
    (tmp_path / "t.nh").write_text("(a:0.1,b:0.1);\n")
    argv = ["-s", str(tmp_path / "s.fas"), "-t", str(tmp_path / "t.nh"),
            "-o", str(tmp_path / "out"), "--silent"]
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(argv)
    assert not (tmp_path / "out.fas").exists()
    assert cli.main(argv + ["--device", "cpu"]) == 0
    assert (tmp_path / "out.fas").read_text().count(">") == 2


@pytest.mark.parametrize("flags", [["-q", "r.fas", "--threads", "2"],
                                   ["--devices", "2"],
                                   ["--jax-coordinator", "127.0.0.1:PORT"],
                                   ["--jax-num-processes", "2"],
                                   ["--jax-process-id", "1"],
                                   ["--threads", "4"]])
def test_unported_flags_raise(tmp_path, flags):
    """The multi-device flags, once ROADMAP Queue 1 item 11's request and
    refused, run (make_mesh): with --device cpu, or one process joining
    a group of one, the run is unsharded and writes the bytes of the run
    without them; --jax-num-processes/--jax-process-id without
    --jax-coordinator are read by nothing, as in the JAX CLI."""
    import socket
    (tmp_path / "s.fas").write_text(">a\nACGTACGTTGCA\n>b\nACGTACTTGCA\n")
    (tmp_path / "t.nh").write_text("(a:0.1,b:0.1);\n")
    (tmp_path / "r.fas").write_text(">q\nACGTACGTTGC\n")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    flags = [f.replace("r.fas", str(tmp_path / "r.fas"))
             .replace("PORT", str(port)) for f in flags]
    argv = ["--device", "cpu", "-s", str(tmp_path / "s.fas"),
            "-t", str(tmp_path / "t.nh"), "--silent"]
    extra = flags[:2] if flags[0] == "-q" else []
    assert cli.main(argv + extra + ["-o", str(tmp_path / "one")]) == 0
    assert cli.main(argv + flags + ["-o", str(tmp_path / "out")]) == 0
    assert (tmp_path / "out.fas").read_bytes() == \
        (tmp_path / "one.fas").read_bytes()


@pytest.mark.parametrize("flags", [["--full-probability"],
                                   ["--sample-path", "--seed", "3"]])
def test_pair_end_with_full_probability_still_raises(tmp_path, flags):
    """Pair-end is ported: with full probability or sampling it no
    longer raises, through the CLI or align_pair, and on a family with
    no break site (no FASTQ joint) it gives the output of the run
    without --pair-end."""
    (tmp_path / "s.fas").write_text(">a\nACGTACGTTGCA\n>b\nACGTACTTGCA\n")
    (tmp_path / "t.nh").write_text("(a:0.1,b:0.1);\n")
    argv = ["--device", "cpu", "-s", str(tmp_path / "s.fas"),
            "-t", str(tmp_path / "t.nh"), "--silent"]
    out = str(tmp_path / "out")
    assert cli.main(argv + ["-o", out + "_pe", "--pair-end"] + flags) == 0
    assert cli.main(argv + ["-o", out] + flags) == 0
    assert open(out + "_pe.fas").read() == open(out + ".fas").read()
    from pagan2_tpu_torch.align import align_pair
    from dataclasses import replace
    g1, g2 = _pair()
    s = replace(AlignSettings(), pair_end_reads=True,
                compute_full_score=True)
    anc, _end = align_pair(g1, g2, MODEL, s, device="cpu")
    assert anc is not None and anc.num_sites() > 20


def test_linear_wrapper_rejects_wrong_dtype():
    g1, g2 = _pair()
    inp = tl._add_scalar_params(prepare_sheared(g1, g2, MODEL,
                                                AlignSettings(), np.float32))
    args = tl.linear_batch_args([tl.linear_job_arrays(inp, 32)], "cpu")
    bad = dict(args, ms=args["ms"].double())
    with pytest.raises(TypeError, match="ms"):
        tl.linear_fill(**bad)
    bad = dict(args, vhi=args["vhi"].long())
    with pytest.raises(TypeError, match="vhi"):
        tl.linear_fill(**bad)
    codes, corner = tl.linear_fill(**args)
    assert codes.dtype == torch.uint8 and torch.isfinite(corner).any()


def test_fanin_wrapper_rejects_wrong_dtype_and_shape():
    g1, g2 = _pair(homopolymer=True)
    inp = tf.prepare_fanin(g1, g2, MODEL, AlignSettings(), np.float32)
    args = tf.fanin_batch_args([inp], "cpu")
    with pytest.raises(TypeError, match="loff"):
        tf.fanin_fill(**dict(args, loff=args["loff"].long()))
    with pytest.raises(ValueError, match="gextj"):
        tf.fanin_fill(**dict(args, gextj=args["gextj"][:, :-1]
                             .contiguous()))
    bp, snap = tf.fanin_fill(**args)
    assert bp.dtype == torch.int32 and snap.shape[1] == 3


def test_cpu_tensors_take_the_plain_version():
    g1, g2 = _pair()
    inp = tl._add_scalar_params(prepare_sheared(g1, g2, MODEL,
                                                AlignSettings(), np.float32))
    args = tl.linear_batch_args([tl.linear_job_arrays(inp, 32)], "cpu")
    n0, p0 = tl.LAUNCHES, tl.PLAIN_CALLS
    tl.linear_fill(**args)
    assert tl.LAUNCHES == n0 and tl.PLAIN_CALLS == p0 + 1
