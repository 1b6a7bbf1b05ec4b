"""Plot alignment datatypes + HMM motif segmentation
(ref: src/trvz/align.rs, align_consensus.rs)."""

from dataclasses import dataclass
from typing import List, Optional, Tuple

from ..hmm import (HmmEvent, get_events, label_motifs,
                   remove_imperfect_motifs)
from ..engine.workflow import cached_hmm

# SegType encoding: ("tr", motif_index) | ("lf",) | ("rf",)
SegType = Tuple


@dataclass
class AlignSeg:
    width: int
    op: str             # match | subst | ins | del
    seg_type: SegType


Align = List[AlignSeg]


@dataclass
class Beta:
    pos: int
    value: float


Betas = List[Beta]


@dataclass
class WfaAlignLike:
    """Unit-op alignment (ops: 'M','X','I','D'), WFA2-convention:
    'I' consumes text/query, 'D' consumes pattern/reference."""
    operations: List[str]
    score: int
    xlen: int
    ylen: int
    xstart: int = 0
    ystart: int = 0


def e2e_align(pattern: bytes, text: bytes,
              scoring=(2, 5, 1)) -> WfaAlignLike:
    from ..kernels.align_host import align_end_to_end
    mism, gapo, gape = scoring
    score, cigar = align_end_to_end(pattern, text, mism, gapo, gape)
    ops = []
    for length, op in cigar:
        c = "M" if op == "=" else op
        ops.extend([c] * length)
    return WfaAlignLike(operations=ops, score=score, xlen=len(pattern),
                        ylen=len(text))


def project_betas(align: WfaAlignLike, betas: Betas) -> Betas:
    # ref: src/trvz/read.rs:24-66
    if not betas:
        return []
    ref_pos = 0
    seq_pos = 0
    beta_index = 0
    proj = []
    for op in align.operations:
        at_pos = betas[beta_index].pos == seq_pos
        is_visible = op in ("M", "X")
        if at_pos and is_visible:
            proj.append(Beta(pos=ref_pos, value=betas[beta_index].value))
        if at_pos:
            beta_index += 1
        if beta_index == len(betas):
            break
        if op in ("M", "X", "I"):
            seq_pos += 1
        if op in ("M", "X", "D"):
            ref_pos += 1
    return proj


def align_motifs(motifs: List[bytes], seq: str) -> Align:
    # ref: align_consensus.rs:33-122
    if not seq:
        return []
    hmm = cached_hmm(tuple(motifs))
    states = hmm.label(seq)
    states = remove_imperfect_motifs(hmm, motifs, states, seq.encode(), 6)
    motif_spans = label_motifs(hmm, states)
    motif_by_base = [len(motifs)] * len(seq)
    for span in motif_spans:
        for i in range(span.start, span.end):
            motif_by_base[i] = span.motif_index

    events = get_events(hmm, motifs, states, seq.encode())
    align: Align = []
    base_pos = 0

    # group consecutive identical events
    groups = []
    for e in events:
        if groups and groups[-1][0] == e:
            groups[-1][1] += 1
        else:
            groups.append([e, 1])

    for event, width in groups:
        if base_pos < len(motif_by_base):
            seg_type = ("tr", motif_by_base[base_pos])
        else:
            assert base_pos == len(motif_by_base)
            seg_type = ("tr", motif_by_base[max(base_pos - 1, 0)])

        if event == HmmEvent.TRANS:
            pass
        elif event in (HmmEvent.MOTIF_START, HmmEvent.MOTIF_END):
            pass
        elif event == HmmEvent.DEL:
            align.append(AlignSeg(0, "ins", seg_type))
        elif event == HmmEvent.INS:
            align.append(AlignSeg(width, "del", seg_type))
        elif event == HmmEvent.MATCH:
            align.append(AlignSeg(width, "match", seg_type))
        elif event == HmmEvent.MISMATCH:
            align.append(AlignSeg(width, "subst", seg_type))
        elif event == HmmEvent.SKIP:
            assert seg_type == ("tr", len(motifs))
            align.append(AlignSeg(width, "match", seg_type))

        if event in (HmmEvent.MATCH, HmmEvent.MISMATCH, HmmEvent.INS,
                     HmmEvent.SKIP):
            base_pos += width

    assert base_pos == len(seq)

    merged: Align = []
    for seg in align:
        if merged and merged[-1].op == seg.op \
                and merged[-1].seg_type == seg.seg_type:
            merged[-1].width += seg.width
        else:
            merged.append(AlignSeg(seg.width, seg.op, seg.seg_type))
    return merged


def align_consensus(locus, consensus: str) -> Align:
    # ref: align_consensus.rs:9-31
    align = [AlignSeg(len(locus.left_flank), "match", ("lf",))]
    motifs = [m.encode() for m in locus.motifs]
    query = consensus[len(locus.left_flank):
                      len(consensus) - len(locus.right_flank)]
    align.extend(align_motifs(motifs, query))
    align.append(AlignSeg(len(locus.right_flank), "match", ("rf",)))
    return align
