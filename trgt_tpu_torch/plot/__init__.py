"""Plot (trvz) pipeline: allele and waterfall read-pileup plots
(ref: src/trvz/ and crates/pipeplot/)."""
