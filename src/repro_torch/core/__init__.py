"""BFLN core on PyTorch (port of ``repro.core``): PAA (prototypes, Pearson,
spectral clustering, cluster-masked FedAvg), CACC consensus, incentives,
the BFLN strategy, the round engine and the chain side of a round."""
