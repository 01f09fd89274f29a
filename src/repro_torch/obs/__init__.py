"""`repro_torch.obs` — the flight recorder: structured tracing + metrics.

Port of ``repro.obs``, with the same names, record layout and sinks:

    spec = ExperimentSpec(obs=ObsSpec(enabled=True, trace_path="run.jsonl"))
    result = run(spec)            # manifest carries the trace file's sha256
    print(result.summary())       # ... | round p50=16.2ms chain=21% compiles=3

The recorder captures wall-clock *and* virtual-clock spans per round phase
and engine stage, ``compile`` events when a round loads a kernel library,
and a metrics registry of per-round counters/gauges with streaming p50/p99
summaries.  On the card a span waits for the kernels it launched
(``ObsSpec.block_until_ready``), so its wall time is the work's, not the
launch's.  Sinks: a schema-validated JSONL trace (digest stamped into the
run manifest), a console summary table, and a Chrome/Perfetto export.

Hard invariant: tracing on vs. off leaves event logs, block hashes, ledger
balances and final accuracy bit-identical — observability may time and
count, never perturb (``tests/test_torch_obs_invariance.py``).
"""
from repro_torch.obs.metrics import MetricsRegistry, Summary  # noqa: F401
from repro_torch.obs.names import (  # noqa: F401
    ALL_NAMES,
    COUNTER_NAMES,
    DYNAMIC_PREFIXES,
    EVENT_NAMES,
    GAUGE_NAMES,
    PORT_SPAN_NAMES,
    SERIES_NAMES,
    SPAN_NAMES,
)
from repro_torch.obs.recorder import (  # noqa: F401
    NULL_RECORDER,
    FlightRecorder,
    NullRecorder,
)
from repro_torch.obs.schema import (  # noqa: F401
    SCHEMA_VERSION,
    validate_record,
    validate_trace_lines,
)
from repro_torch.obs.sinks import (  # noqa: F401
    console_summary,
    file_sha256,
    write_chrome_trace,
    write_jsonl,
)
from repro_torch.obs.spec import ObsSpec  # noqa: F401
