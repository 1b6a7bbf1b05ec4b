"""Allele and waterfall plot construction (ref: src/trvz/allele_plot.rs,
align_allele.rs, align_reads.rs, waterfall_plot.rs, scale.rs)."""

from typing import List, Tuple

from .align import (Align, AlignSeg, Beta, Betas, WfaAlignLike,
                    align_consensus, align_motifs, e2e_align,
                    project_betas)
from .params import COLORS, ColorMap, PlotParams, get_meth_colors, gradient
from .pipeplot import Band, FontConfig, Legend, Pipe, PipePlot, Seg


def get_scale(xpos: int, ypos: int, height: int, align: Align) -> Pipe:
    # ref: scale.rs:5-35
    lf_len = sum(s.width for s in align if s.seg_type == ("lf",))
    allele_len = sum(s.width for s in align
                     if s.seg_type not in (("lf",), ("rf",)))
    label = f"{allele_len}bp"
    seg = Seg(width=allele_len, color=COLORS["black"],
              shape="double_arrow", label=label)
    return Pipe(xpos=xpos + lf_len, ypos=ypos, height=height, segs=[seg],
                bands=[], outline=False)


def _get_pipe(xpos, ypos, height, align: Align, betas: Betas,
              colors: ColorMap, outline: bool) -> Pipe:
    # ref: allele_plot.rs:107-157
    segs = []
    for seg in align:
        if seg.op == "del":
            shape = "hline"
        elif seg.op == "ins":
            shape = "vline"
        else:
            shape = "rect"
        if seg.op == "match":
            color = colors[seg.seg_type]
        elif seg.op == "subst":
            color = COLORS["gray"]
        else:
            color = COLORS["black"]
        segs.append(Seg(width=seg.width, color=color, shape=shape))
    bands = [Band(pos=b.pos, width=2, color=gradient(b.value))
             for b in betas]
    return Pipe(xpos=xpos, ypos=ypos, height=height, segs=segs,
                bands=bands, outline=outline)


def _convert_read_align(consensus_align: Align,
                        wfa: WfaAlignLike) -> Align:
    # ref: align_reads.rs:31-113
    seg_type_by_ref = []
    for seg in consensus_align:
        if seg.op in ("del", "match", "subst"):
            seg_type_by_ref.extend([seg.seg_type] * seg.width)

    ops_and_segs = []
    ref_pos = 0
    for op in wfa.operations:
        if ref_pos == len(seg_type_by_ref):
            assert op == "I"
            seg_type = seg_type_by_ref[ref_pos - 1]
        else:
            seg_type = seg_type_by_ref[ref_pos]
        ops_and_segs.append((op, seg_type))
        if op in ("M", "X", "D"):
            ref_pos += 1

    align: Align = []
    groups = []
    for rec in ops_and_segs:
        if groups and groups[-1][0] == rec:
            groups[-1][1] += 1
        else:
            groups.append([rec, 1])
    for (op, seg_type), run_len in groups:
        if op == "M":
            align.append(AlignSeg(run_len, "match", seg_type))
        elif op == "X":
            align.append(AlignSeg(run_len, "subst", seg_type))
        elif op == "D":
            align.append(AlignSeg(run_len, "del", seg_type))
        else:
            align.append(AlignSeg(0, "ins", seg_type))
    return align


def _convert_flank_align(wfa: WfaAlignLike, seg_type) -> Align:
    # ref: waterfall_plot.rs:132-191
    align: Align = []
    groups = []
    for op in wfa.operations:
        if groups and groups[-1][0] == op:
            groups[-1][1] += 1
        else:
            groups.append([op, 1])
    for op, run_len in groups:
        if op == "M":
            align.append(AlignSeg(run_len, "match", seg_type))
        elif op == "X":
            align.append(AlignSeg(run_len, "subst", seg_type))
        elif op == "D":
            align.append(AlignSeg(run_len, "del", seg_type))
        else:
            align.append(AlignSeg(0, "ins", seg_type))
    return align


def align_reads(consensus: str, consensus_align: Align, reads):
    # ref: align_reads.rs:7-28 — sort by (len, -score)
    ret = []
    for read in reads:
        wfa = e2e_align(consensus.encode(), read.seq.encode())
        align = _convert_read_align(consensus_align, wfa)
        betas = project_betas(wfa, read.betas)
        ret.append((align, betas, wfa.score, len(read.seq)))
    ret.sort(key=lambda r: (r[3], -r[2]))
    return [(r[0], r[1]) for r in ret]


def plot_alleles(locus, what_to_show: str, allele_seqs: List[str], reads,
                 params: PlotParams) -> PipePlot:
    # ref: allele_plot.rs:11-105
    aligns_by_allele = []
    for index, allele_seq in enumerate(allele_seqs):
        allele_reads = [r for r in reads if r.allele == index]
        consensus_align = align_consensus(locus, allele_seq)
        read_aligns = align_reads(allele_seq, consensus_align,
                                  allele_reads)
        aligns_by_allele.append((consensus_align, read_aligns))

    allele_height = 4
    xpos = 0
    ypos = 0
    pipes = []
    for allele_index, (seq_align, read_aligns) in \
            enumerate(aligns_by_allele):
        pipes.append(get_scale(xpos, ypos, allele_height, seq_align))
        ypos += allele_height
        pipes.append(_get_pipe(xpos, ypos, allele_height, seq_align, [],
                               params.colors, True))
        ypos += allele_height + params.pipe_pad
        if params.pipe_pad == 0:
            ypos += 1
        for align, betas in read_aligns:
            if what_to_show == "meth":
                colors, use_betas = get_meth_colors(locus.motifs), betas
            else:
                colors, use_betas = params.colors, []
            pipes.append(_get_pipe(xpos, ypos, params.pipe_height, align,
                                   use_betas, colors, False))
            ypos += params.pipe_height + params.pipe_pad
        if allele_index + 1 != len(aligns_by_allele):
            ypos += 7

    labels = []
    for index, motif in enumerate(locus.motifs):
        labels.append((motif, params.colors[("tr", index)]))
    if what_to_show == "meth":
        labels.append(("Methylated", gradient(1.0)))
        labels.append(("Unmethylated", gradient(0.0)))
    ypos += 1
    legend = Legend(xpos=xpos, ypos=ypos, height=allele_height,
                    labels=labels)
    return PipePlot(pipes=pipes, legend=legend)


def _waterfall_align(locus, longest_read: int, read):
    # ref: waterfall_plot.rs:42-129
    lf_len = len(locus.left_flank)
    rf_len = len(locus.right_flank)
    lf_read = read.seq[:lf_len]
    rf_read = read.seq[len(read.seq) - rf_len:]

    lf_wfa = e2e_align(locus.left_flank.encode(), lf_read.encode())
    align = _convert_flank_align(lf_wfa, ("lf",))
    tr = read.seq[lf_len:len(read.seq) - rf_len]
    motifs = [m.encode() for m in locus.motifs]
    align.extend(align_motifs(motifs, tr))
    deletion_width = max(0, longest_read - len(read.seq))
    if deletion_width > 0:
        align.append(AlignSeg(deletion_width, "del", ("rf",)))
    rf_wfa = e2e_align(locus.right_flank.encode(), rf_read.encode())
    align.extend(_convert_flank_align(rf_wfa, ("rf",)))

    proj = []
    lf_betas = [b for b in read.betas if b.pos < len(lf_read)]
    proj.extend(project_betas(lf_wfa, lf_betas))
    tr_betas = [Beta(pos=b.pos - len(lf_read), value=b.value)
                for b in read.betas
                if len(lf_read) <= b.pos < len(lf_read) + len(tr)]
    proj.extend(Beta(pos=b.pos + len(lf_read), value=b.value)
                for b in tr_betas)
    rf_betas = [Beta(pos=b.pos - len(lf_read) - len(tr), value=b.value)
                for b in read.betas
                if len(lf_read) + len(tr) <= b.pos]
    proj.extend(
        Beta(pos=b.pos + len(lf_read) + len(tr) + longest_read
             - len(read.seq), value=b.value)
        for b in project_betas(rf_wfa, rf_betas))
    return align, proj


def plot_waterfall(locus, what_to_show: str, reads,
                   params: PlotParams) -> PipePlot:
    # ref: waterfall_plot.rs:22-40, 193-249
    reads = sorted(reads, key=lambda r: len(r.seq))
    longest = max(len(r.seq) for r in reads)
    aligned = [_waterfall_align(locus, longest, r) for r in reads]

    xpos = 0
    ypos = 0
    pipes = [get_scale(xpos, ypos, params.pipe_height, aligned[-1][0])]
    ypos += 4
    for align, betas in aligned:
        if what_to_show == "meth":
            colors, use_betas = get_meth_colors(locus.motifs), betas
        else:
            colors, use_betas = params.colors, []
        pipes.append(_waterfall_pipe(xpos, ypos, params.pipe_height,
                                     align, use_betas, colors))
        ypos += params.pipe_height + params.pipe_pad

    if what_to_show == "motifs":
        labels = [(motif, params.colors[("tr", i)])
                  for i, motif in enumerate(locus.motifs)]
    else:
        labels = [("Methylated", gradient(1.0)),
                  ("Unmethylated", gradient(0.0))]
    ypos += 1
    legend = Legend(xpos=xpos, ypos=ypos, height=4, labels=labels)
    return PipePlot(pipes=pipes, legend=legend)


def _waterfall_pipe(xpos, ypos, height, align: Align, betas: Betas,
                    colors: ColorMap) -> Pipe:
    # ref: waterfall_plot.rs:251-291 (Del drawn light gray here)
    segs = []
    for seg in align:
        if seg.op == "del":
            shape = "hline"
        elif seg.op == "ins":
            shape = "vline"
        else:
            shape = "rect"
        if seg.op == "match":
            color = colors[seg.seg_type]
        elif seg.op == "subst":
            color = COLORS["gray"]
        elif seg.op == "del":
            color = COLORS["lightgray"]
        else:
            color = COLORS["black"]
        segs.append(Seg(width=seg.width, color=color, shape=shape))
    bands = [Band(pos=b.pos, width=2, color=gradient(b.value))
             for b in betas]
    return Pipe(xpos=xpos, ypos=ypos, height=height, segs=segs,
                bands=bands, outline=False)
