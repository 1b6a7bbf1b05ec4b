from .gt import TrSize
from .span import find_tr_spans
from . import size as genotype_size
from . import cluster as genotype_cluster
from . import flank as genotype_flank

__all__ = ["TrSize", "find_tr_spans", "genotype_size", "genotype_cluster",
           "genotype_flank"]
