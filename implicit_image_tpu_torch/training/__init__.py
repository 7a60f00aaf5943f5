"""Training: the fit loop (dense or sparse), the k-means codebook finetune
(absolute or delta) and the meta-init warm start."""
