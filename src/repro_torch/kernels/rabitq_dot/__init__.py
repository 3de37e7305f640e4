"""RaBitQ estimator kernels: the fused search step
(`csrc/rabitq_search_step.cu`), and `rabitq_gather_distance` and
`rabitq_distance` (`csrc/rabitq_distance.cu`)."""
