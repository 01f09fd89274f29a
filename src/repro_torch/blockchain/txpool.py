"""Transaction pool for the BFLN chain (copy of ``repro.blockchain.txpool``)."""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field


@dataclass(frozen=True)
class Transaction:
    kind: str        # "model_hash" | "agg_commit" | "agg_hash" (legacy)
                     # | "reward" | "fee" | "stake"
    sender: int      # client id (-1 = network)
    payload: str     # hash hex / JSON body
    round_idx: int

    def tx_hash(self) -> str:
        # memoised: computed at submit, reused by merkle build + validation
        # (frozen dataclass -> write through __dict__; not a compared field)
        h = self.__dict__.get("_tx_hash")
        if h is None:
            body = json.dumps(
                {"kind": self.kind, "sender": self.sender,
                 "payload": self.payload, "round": self.round_idx},
                sort_keys=True)
            h = hashlib.sha256(body.encode()).hexdigest()
            object.__setattr__(self, "_tx_hash", h)
        return h


@dataclass
class TxPool:
    pending: list[Transaction] = field(default_factory=list)

    def submit(self, tx: Transaction) -> str:
        self.pending.append(tx)
        return tx.tx_hash()

    def drain(self) -> list[Transaction]:
        txs, self.pending = self.pending, []
        return txs

    def __len__(self) -> int:
        return len(self.pending)
