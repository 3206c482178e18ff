"""Debug plot writers: MetaPost sequence-graph figures
(--mpost-graph-file; Node::write_metapost_sequence_graph,
node.cpp:1063-1411), MetaPost DP posterior heatmaps
(--mpost-posterior-plot-file [--plot-slope-up];
Viterbi_alignment::plot_posterior_probabilities_*,
viterbi_alignment.cpp:2457-2909) and anchor dumps for R
(--plot-anchors-for-R; find_anchors.cpp:870-928).

The MetaPost output is self-contained: the helper macros the reference
expects from its LaTeX wrapper are emitted inline so `mpost file.mp`
compiles directly.
"""
from __future__ import annotations

import numpy as np

_MP_PRELUDE = """% pagan2-tpu sequence graphs
vardef circle(expr pos, lab, col) =
  save p; path p;
  p := fullcircle scaled 0.35cm shifted pos;
  fill p withcolor col; draw p;
  label(lab, pos);
  p
enddef;
def edgetop(expr a, b, ang, lab, w) =
  drawarrow (point 0.5 of a){dir ang} .. {dir -ang}(point 0.5 of b)
    withpen pencircle scaled (w*1pt);
  label.top(lab, 0.5[point 0.5 of a, point 0.5 of b] shifted (0,0.2cm));
enddef;
def edgebot(expr a, b, ang, lab, w) =
  drawarrow (point 8 of a) .. (point 8 of b)
    withpen pencircle scaled (w*1pt);
  label.bot(lab, 0.5[point 8 of a, point 8 of b]);
enddef;
"""


def _site_char(g, i: int) -> str:
    from ..graph.sequence_graph import REAL_SITE, STOP_SITE
    if g.site_type[i] == REAL_SITE:
        return g.symbols[i] if g.symbols[i] not in ("", "0") else "n"
    if g.site_type[i] == STOP_SITE:
        return "e"
    return "s"


def _fill_color(c: str) -> str:
    # get_node_fill_color (node.cpp): pale per-base colors
    return {"A": "(0.8,1,0.8)", "C": "(0.8,0.8,1)",
            "G": "(1,0.8,0.8)", "T": "(1,1,0.8)",
            "U": "(1,1,0.8)"}.get(c.upper(), "0.9white")


def write_mpost_sequence_graphs(tree, path: str,
                                include_leaves: bool = False,
                                include_alignment_graphs: bool = False):
    """One MetaPost figure per internal node's sequence graph; leaves
    with --output-leaf-graphs, per-node alignment graphs (child index
    annotations) with --output-alignment-graphs
    (Node::write_metapost_graphs, node.h:2139-2157)."""
    count = 1
    with open(path, "w") as f:
        f.write(_MP_PRELUDE)
        for node in tree.nodes_postorder():
            g = node.graph
            if g is None:
                continue
            if node.is_leaf and not include_leaves:
                continue
            if include_alignment_graphs and not node.is_leaf:
                f.write("%% alignment graph of %s: site -> "
                        "(left child site, right child site)\n"
                        % node.name)
                pairs = " ".join("%d:(%d,%d)" % (j, g.child_l[j],
                                                 g.child_r[j])
                                 for j in range(g.num_sites()))
                f.write("%% %s\n" % pairs)
            f.write("beginfig(%d);\n"
                    "pickup pencircle scaled 1pt;\npath c[];\n"
                    "defaultscale := 0.5;\n" % count)
            n = g.num_sites()
            for i in range(n):
                c = _site_char(g, i)
                color = _fill_color(c)
                if g.site_bcount_slu[i] > 0:
                    color = "0.5white"
                f.write('c%d = circle((%.2fcm,0cm),"%s",%s);\n'
                        % (i, 0.5 * i, c, color))
            f.write('label.top("%s",(0.125cm,0.25cm));\n' % node.name)
            f.write("defaultscale := 0.25;\n")
            for e in range(len(g.edges)):
                start = int(g.edges.start[e])
                stop = int(g.edges.end[e])
                if stop <= start:
                    continue
                gap = stop - start
                place, angle = "edgetop", 0
                if gap == 1:
                    place = "edgebot"
                elif gap == 2:
                    angle = 40
                elif gap == 3:
                    angle = 30
                else:
                    angle = 20
                lab = ""
                if g.edges.bcount_slu[e] > 0:
                    lab = "[%d %d %.3g]" % (g.edges.bcount_slu[e],
                                            g.edges.bcount_skip[e],
                                            g.edges.bdist_slu[e])
                f.write('%s(c%d,c%d,%d,"%s",%.2f);\n'
                        % (place, start, stop, angle, lab,
                           max(float(g.edges.weight[e]), 0.1)))
            f.write("endfig;\n\n")
            count += 1
        f.write("end;\n")


_POSTERIOR_SINK: list | None = None


def open_posterior_sink():
    """Arm posterior-figure collection; align_pair feeds figures in."""
    global _POSTERIOR_SINK
    _POSTERIOR_SINK = []


def posterior_sink_active() -> bool:
    return _POSTERIOR_SINK is not None


def add_posterior_figure(aligner, title: str = ""):
    """Record one pairwise DP posterior matrix from a filled
    PairAligner (requires compute_full_score)."""
    if _POSTERIOR_SINK is None:
        return
    L, R = aligner.L, aligner.R
    post = np.zeros((L - 1, R - 1))
    for i in range(L - 1):
        for j in range(R - 1):
            post[i, j] = max(aligner.M[i][j].full_score,
                             aligner.X[i][j].full_score,
                             aligner.Y[i][j].full_score)
    _POSTERIOR_SINK.append((title, post))


def add_posterior_figure_planes(planes, title: str = ""):
    """Record one pairwise DP posterior matrix from device-computed
    probability planes (align.fullprob.FullProbPlanes)."""
    if _POSTERIOR_SINK is None:
        return
    _POSTERIOR_SINK.append((title, planes.posterior_plane()))


def write_mpost_posterior_plots(path: str, slope_up: bool = False):
    """Flush collected posterior matrices as MetaPost heatmaps.
    slope_up mirrors --plot-slope-up (y axis increasing upward)."""
    global _POSTERIOR_SINK
    figs = _POSTERIOR_SINK or []
    with open(path, "w") as f:
        f.write("% pagan2-tpu DP posterior heatmaps\n")
        for k, (title, post) in enumerate(figs, start=1):
            f.write("beginfig(%d);\n" % k)
            if title:
                f.write('label.top("%s",(0,0.3cm));\n' % title)
            L, R = post.shape
            step = 0.1
            for i in range(L):
                y = i if slope_up else (L - 1 - i)
                for j in range(R):
                    v = float(post[i, j])
                    if v <= 0.01:
                        continue
                    shade = max(0.0, 1.0 - v)
                    f.write("fill unitsquare scaled %.2fcm shifted "
                            "(%.2fcm,%.2fcm) withcolor (1,%.2f,%.2f);\n"
                            % (step, j * step, y * step, shade, shade))
            f.write("draw unitsquare xscaled %.2fcm yscaled %.2fcm;\n"
                    % (R * step, L * step))
            f.write("endfig;\n\n")
        f.write("end;\n")
    _POSTERIOR_SINK = None


def write_anchors_for_R(hits, upper, lower, path: str):
    """Anchor hits + tunnel bounds as an R-readable table
    (find_anchors.cpp:870-928: x/y segments to plot() over the DP
    matrix)."""
    with open(path, "w") as f:
        f.write("# anchors: segments(x1,y1,x2,y2); tunnel: upper/lower\n")
        f.write("anc_x1 <- c(%s)\n" % ",".join(str(h.start_site_1)
                                               for h in hits))
        f.write("anc_y1 <- c(%s)\n" % ",".join(str(h.start_site_2)
                                               for h in hits))
        f.write("anc_x2 <- c(%s)\n" % ",".join(
            str(h.start_site_1 + h.length) for h in hits))
        f.write("anc_y2 <- c(%s)\n" % ",".join(
            str(h.start_site_2 + h.length) for h in hits))
        if upper is not None:
            f.write("tunnel_upper <- c(%s)\n"
                    % ",".join(str(int(v)) for v in upper))
            f.write("tunnel_lower <- c(%s)\n"
                    % ",".join(str(int(v)) for v in lower))
        if hits:
            f.write('plot(anc_x1, anc_y1, type="n")\n'
                    "segments(anc_x1, anc_y1, anc_x2, anc_y2)\n")
        else:
            # plot(c(), ...) errors in R; give the no-anchors dump a
            # runnable frame
            f.write('plot(0, 0, type="n")\n')
