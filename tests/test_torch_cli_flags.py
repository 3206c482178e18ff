"""The rest of the JAX CLI in the port, the parts that need no JAX CLI
run beside it: --checkpoint-dir save and resume (the cases of
tests/test_progressive.py::test_checkpoint_resume), --translate end to
end (tests/test_translate.py's CLI cases), --score-as-dna with
--translate forcing --terminal-nodes, --jax-profile's torch.profiler
trace, --version offline, the ML ancestors' errors left to surface,
and the flag sweep of tests/test_flags_wiring.py against the port's
parser: every flag has the JAX CLI's consumer, and no flag raises
not_ported any more. Everything runs with --device cpu (the kernels'
plain versions)."""
import importlib.util
import json
import os
import pathlib
import re

import pytest

import pagan2_tpu_torch
import pagan2_tpu_torch.cli as P_CLI
import pagan2_tpu_torch.parallel.executor as P_EX
import pagan2_tpu_torch.pipeline.ancestors as P_AN
import pagan2_tpu_torch.pipeline.placement as P_PL
from pagan2_tpu_torch.io.fasta import FastaEntry, read_fasta
from pagan2_tpu_torch.pipeline.progressive import align_progressive
from pagan2_tpu_torch.tools.bench_fanin import family
from pagan2_tpu_torch.tools.reads import write_reads

import pagan2_tpu
from pagan2_tpu.cli import build_parser as jax_parser
from test_flags_wiring import ALLOWED_NOOP

# more than one device: the last part of the JAX CLI the port took
MULTI_DEVICE = ("threads", "devices", "jax_coordinator",
                "jax_num_processes", "jax_process_id")


def _entries(d):
    return [FastaEntry(name=k, sequence=v) for k, v in d.items()]


def _run(argv):
    return P_CLI.main(["--device", "cpu", "--silent"] + argv)


@pytest.fixture(scope="module")
def fam(tmp_path_factory):
    """A 6 x 90 family of tools/bench_fanin.py's generator and its
    tree."""
    d = tmp_path_factory.mktemp("cli_flags")
    seqs, tree = family(6, 90)
    write_reads(str(d / "fam.fas"), seqs)
    (d / "fam.nh").write_text(tree + "\n")
    return d


def test_checkpoint_resume(tmp_path):
    """tests/test_progressive.py::test_checkpoint_resume on the port: a
    restarted run loads finished subtree graphs from the checkpoint dir
    (no fill at all) and gives the same alignment; a partly filled dir
    resumes the rest; another run, or the same input under other
    settings, is refused."""
    from dataclasses import replace
    from pagan2_tpu_torch.align import AlignSettings
    seqs = {f"s{i}": s for i, s in enumerate(
        ["ACGTACGTGGACTTAC", "ACGTACGGACTTAGGT",
         "ACGTATGTGGACTTAC", "ACCTACGTGGATTTAC"])}
    tree = "((s0:0.1,s1:0.1):0.05,(s2:0.1,s3:0.1):0.05);"
    ck = str(tmp_path / "ck")

    def run(**kw):
        return align_progressive(_entries(kw.pop("seqs", seqs)),
                                 kw.pop("tree", tree), data_type="dna",
                                 checkpoint_dir=ck, device="cpu", **kw)
    rows1 = {e.name: e.sequence for e in run().alignment}
    files = sorted(f for f in os.listdir(ck) if f.endswith(".npz"))
    assert len(files) == 3          # three internal nodes

    P_EX.reset_stats()
    assert {e.name: e.sequence for e in run().alignment} == rows1
    assert P_EX.EXEC_STATS["batched_jobs"] == 0
    assert P_EX.EXEC_STATS["single_jobs"] == 0

    # partial resume: drop the root checkpoint, only it recomputes
    os.remove(os.path.join(ck, files[-1]))
    P_EX.reset_stats()
    assert {e.name: e.sequence for e in run().alignment} == rows1
    assert P_EX.EXEC_STATS["batched_jobs"] + \
        P_EX.EXEC_STATS["single_jobs"] == 1, P_EX.EXEC_STATS

    with pytest.raises(ValueError, match="different run"):
        run(seqs={"a": "ACGTACGTGGACTTAC", "b": "ACGTACGGACTTAGGT"},
            tree="(a:0.1,b:0.1);")
    with pytest.raises(ValueError, match="different run"):
        run(settings=replace(AlignSettings(), branch_skip_probability=0.5))
    with pytest.raises(ValueError, match="different run"):
        run(homopolymer=True)


def test_cli_checkpoint_resumes_to_the_same_bytes(fam, tmp_path):
    """Through the CLI: a run after the root's and one internal node's
    .npz are deleted writes the uninterrupted run's bytes; the same
    directory under another --indel-rate raises the JAX module's
    ValueError."""
    ck = str(tmp_path / "ck")
    base = ["-s", str(fam / "fam.fas"), "-t", str(fam / "fam.nh"),
            "--checkpoint-dir", ck, "--output-ancestors"]
    assert _run(base + ["-o", str(tmp_path / "a")]) == 0
    npz = sorted(f for f in os.listdir(ck) if f.endswith(".npz"))
    assert len(npz) == 5 and os.path.exists(os.path.join(ck,
                                                         "manifest.json"))
    from pagan2_tpu_torch.tree.newick import parse_newick
    tree = parse_newick((fam / "fam.nh").read_text())
    tree.name_internal()
    inner = [n.name for n in tree.nodes_postorder() if not n.is_leaf]
    for name in (tree.name, inner[0]):      # the root and a first pair
        os.remove(os.path.join(ck, name.replace("#", "n") + ".npz"))
    assert _run(base + ["-o", str(tmp_path / "b")]) == 0
    for sfx in (".fas", ".anctree"):
        a = (tmp_path / ("a" + sfx)).read_bytes()
        assert a and a == (tmp_path / ("b" + sfx)).read_bytes(), sfx
    with pytest.raises(ValueError, match="different run"):
        _run(base + ["--indel-rate", "0.02", "-o", str(tmp_path / "c")])


def test_cli_translate_end_to_end(tmp_path):
    """tests/test_translate.py::test_cli_translate_end_to_end on the
    port: two CDSs aligned as protein, the .codon file their DNA."""
    d1 = "ATGGCTAAATTTGGGCATCCGTTA"
    d2 = "ATGGCGAAATTTGGGTATCCGTTA"
    (tmp_path / "cds.fas").write_text(">s1\n%s\n>s2\n%s\n" % (d1, d2))
    (tmp_path / "t.nh").write_text("(s1:0.1,s2:0.1);\n")
    out = str(tmp_path / "out")
    assert _run(["-s", str(tmp_path / "cds.fas"), "-t",
                 str(tmp_path / "t.nh"), "-o", out, "--translate"]) == 0
    prot = {e.name: e.sequence for e in read_fasta(out + ".fas")}
    assert prot == {"s1": "MAKFGHPL", "s2": "MAKFGYPL"}
    codon = {e.name: e.sequence for e in read_fasta(out + ".codon.fas")}
    assert codon == {"s1": d1, "s2": d2}


def test_cli_translate_rejects_protein(tmp_path):
    (tmp_path / "prot.fas").write_text(">p1\nMAKF\n>p2\nMAKY\n")
    (tmp_path / "t.nh").write_text("(p1:0.1,p2:0.1);\n")
    with pytest.raises(SystemExit):
        _run(["-s", str(tmp_path / "prot.fas"), "-t",
              str(tmp_path / "t.nh"), "--translate",
              "-o", str(tmp_path / "o")])


def test_score_as_dna_with_translate_forces_terminal_nodes(tmp_path,
                                                          monkeypatch):
    """reads_aligner.cpp:2940: --score-as-dna with --translate places on
    terminal nodes only (as the JAX CLI's handle_queries sets it), and
    the queries' DNA joins the run's dna_map."""
    seen = {}
    place = P_PL.place_queries

    def spy(res, queries, data_type, cfg, **kw):
        seen["cfg"], seen["dna_map"] = cfg, dict(kw["dna_map"])
        return place(res, queries, data_type, cfg, **kw)
    monkeypatch.setattr(P_PL, "place_queries", spy)
    cds = {"s1": "ATGGCTAAATTTGGGCATCCGTTAGGA",
           "s2": "ATGGCGAAATTTGGGTATCCGTTAGGA",
           "s3": "ATGGCGAAATTCGGGTATCCGTTAGGC"}
    write_reads(str(tmp_path / "cds.fas"), list(cds.items())[:2])
    write_reads(str(tmp_path / "q.fas"), [("s3", cds["s3"])])
    (tmp_path / "t.nh").write_text("(s1:0.1,s2:0.1);\n")
    out = str(tmp_path / "out")
    assert _run(["-s", str(tmp_path / "cds.fas"), "-t",
                 str(tmp_path / "t.nh"), "-q", str(tmp_path / "q.fas"),
                 "--translate", "--score-as-dna", "--all-nodes",
                 "-o", out]) == 0
    cfg = seen["cfg"]
    assert cfg.score_as_dna and cfg.terminal_nodes
    assert not (cfg.internal_nodes or cfg.all_nodes)
    assert seen["dna_map"] == cds
    codon = {e.name: e.sequence.replace("-", "")
             for e in read_fasta(out + ".codon.fas")}
    assert codon == cds


def test_jax_profile_writes_a_torch_profiler_trace(tmp_path, capsys):
    """--jax-profile PATH records a torch.profiler trace of the run (on
    the CPU its CPU activities) as Chrome trace JSON and says where."""
    trace = tmp_path / "trace.json"
    write_reads(str(tmp_path / "pair.fas"), [("a", "ACGTTGCAAGGCTTACGA"),
                                             ("b", "ACGTTGCAGGCTTACGTA")])
    (tmp_path / "pair.nh").write_text("(a:0.1,b:0.1);\n")
    assert P_CLI.main(["--device", "cpu", "-s", str(tmp_path / "pair.fas"),
                       "-t", str(tmp_path / "pair.nh"), "-o",
                       str(tmp_path / "o"), "--jax-profile",
                       str(trace)]) == 0
    assert "torch profiler trace -> %s" % trace in capsys.readouterr().err
    events = json.loads(trace.read_text())["traceEvents"]
    assert any(e.get("ph") == "X" for e in events)
    assert "PyTorch profiler" in P_CLI.build_parser().format_help()


def test_version_prints_the_offline_notice(monkeypatch, capsys):
    """--version runs the verbatim copy of utils/check_version.py after
    the banner; with the update check refused (no connection is made
    here) it prints its one-line notice and returns 0."""
    import urllib.request

    def refused(*a, **kw):
        raise OSError("no network")
    monkeypatch.setattr(urllib.request, "urlopen", refused)
    assert P_CLI.main(["--version"]) == 0
    said = capsys.readouterr()
    assert said.out.startswith("pagan2-tpu-torch v%s"
                               % pagan2_tpu_torch.__version__)
    assert "update check failed (OSError)" in said.err


def test_ml_ancestor_errors_are_not_swallowed(fam, tmp_path, monkeypatch):
    """The JAX CLI drops every exception of reconstruct_ml_ancestors; the
    port calls it with no except, so an error there stops the run."""
    def broken(tree, mf, *a, **kw):
        raise FloatingPointError("ML pass")
    monkeypatch.setattr(P_AN, "reconstruct_ml_ancestors", broken)
    argv = ["-s", str(fam / "fam.fas"), "-t", str(fam / "fam.nh"),
            "-o", str(tmp_path / "o"), "--output-ancestors"]
    with pytest.raises(FloatingPointError):
        _run(argv)
    assert _run(argv + ["--no-bppancestors"]) == 0


def _consumers(pkg, dests):
    """dest -> the package's files (relative) whose text holds
    `args.<dest>` (the JAX test's own rule)."""
    root = pathlib.Path(pkg.__file__).parent
    texts = {str(p.relative_to(root)): p.read_text()
             for p in root.rglob("*.py")}
    return {d: {f for f, t in texts.items() if "args.%s" % d in t}
            for d in dests}


def test_every_jax_flag_has_the_same_consumer_in_the_port():
    """tests/test_flags_wiring.py::test_every_parsed_flag_has_a_consumer
    against the port: the parsers take the same flags (the port adds
    --device); each flag the JAX package reads is read by the port in
    the same files; the documented no-ops are read by neither; the
    multi-device flags are read by the CLI, as in the JAX package."""
    jax_dests = {a.dest for a in jax_parser()._actions} - {"help",
                                                          "full_help"}
    port_dests = {a.dest for a in P_CLI.build_parser()._actions} - \
        {"help", "full_help"}
    assert port_dests == jax_dests | {"device"}
    jax_use = _consumers(pagan2_tpu, jax_dests)
    port_use = _consumers(pagan2_tpu_torch, jax_dests)
    missing = {d: (jax_use[d], port_use[d]) for d in jax_dests
               if d not in ALLOWED_NOOP and
               not (jax_use[d] and jax_use[d] <= port_use[d])}
    assert missing == {}
    assert [d for d in ALLOWED_NOOP if port_use[d]] == []
    assert all("cli.py" in port_use[d] for d in MULTI_DEVICE)


def test_only_more_than_one_device_raises_not_ported(fam, tmp_path):
    """With this slice nothing is left to port: pending.py and the CLI's
    unported_request are gone, and each multi-device request with
    --device cpu runs unsharded, writing the bytes of the run without
    it (the JAX CLI makes no mesh on one device either)."""
    assert importlib.util.find_spec("pagan2_tpu_torch.pending") is None
    assert not hasattr(P_CLI, "unported_request")
    base = ["--device", "cpu", "--silent", "-s", str(fam / "fam.fas"),
            "-t", str(fam / "fam.nh")]
    assert P_CLI.main(base + ["-o", str(tmp_path / "one")]) == 0
    want = (tmp_path / "one.fas").read_bytes()
    for k, extra in enumerate((["--threads", "2"], ["--devices", "4"],
                               ["--jax-num-processes", "2"],
                               ["--jax-process-id", "1"])):
        out = str(tmp_path / ("o%d" % k))
        assert P_CLI.main(base + extra + ["-o", out]) == 0, extra
        assert (tmp_path / ("o%d.fas" % k)).read_bytes() == want, extra
