from repro_torch.data.partition import (  # noqa: F401
    dirichlet_partition,
    pack_clients,
    sample_probe_batch,
)
from repro_torch.data.synthetic import SyntheticSpec, make_classification_dataset  # noqa: F401
