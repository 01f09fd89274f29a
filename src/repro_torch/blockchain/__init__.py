from repro_torch.blockchain.chain import Block, Blockchain, hash_params  # noqa: F401
from repro_torch.blockchain.commit import (  # noqa: F401
    AGG_COMMIT_KIND,
    MODEL_COMMIT_KIND,
    MODEL_RELEASE_KIND,
    RELEASE_COMMIT_KIND,
    MerkleProof,
    RoundCommitments,
    commitment_leaf,
    verify_membership,
)
from repro_torch.blockchain.ledger import TokenLedger  # noqa: F401
from repro_torch.blockchain.txpool import Transaction, TxPool  # noqa: F401
