from .model import Hmm, build_hmm, encode_base
from .decode import (
    HmmEvent,
    Span,
    Annotation,
    get_events,
    get_base_match,
    calc_purity,
    remove_imperfect_motifs,
    label_motifs,
    collapse_labels,
    count_motifs,
    replace_invalid_bases,
)

__all__ = [
    "Hmm", "build_hmm", "encode_base", "HmmEvent", "Span", "Annotation",
    "get_events", "get_base_match", "calc_purity", "remove_imperfect_motifs",
    "label_motifs", "collapse_labels", "count_motifs", "replace_invalid_bases",
]
