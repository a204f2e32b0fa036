"""``spans_run.py`` with each CUDA graph replay's device operations put down
to the program spans that captured them (``graph_spans.py``), on the NGP,
serving and SDF training cells.

    python3 bench_torch/graph_spans_run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1> [--rehearse]

The serving and NGP training cells run as ``spans_run.py`` runs them. The
SDF training cells (``train_neus_ngp``, ``train_volsdf``) run their own
drivers, whose traced windows already run with the program's spans on; here
their readings gain the span keys, and ``--trace 0`` runs their window with
spans on and the profiler off, as ``spans_run.py`` does for the others. The
result line adds the per-layer metrics of ``METRICS`` (readers in
``metrics/``) to those of ``spans_run.METRICS``, and ``spans`` gains
``span_unmapped_replays``: the replays whose device operations did not
match their graph's map, left on the replay span.

Nothing here changes what ``run.py`` measures: it wraps the drivers and the
profiled window from outside and reads the result line ``run.py`` prints.
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
if os.path.dirname(HERE) not in sys.path:
    sys.path.insert(0, os.path.dirname(HERE))

from bench_torch import graph_spans, spans, spans_run  # noqa: E402
from bench_torch.drivers import train_neus, train_volsdf  # noqa: E402

VOLSDF, NEUS = ["train_volsdf"], ["train_neus_ngp"]
SAMPLER = "error-bound sampler and SDF elementwise work (VolSDF.upsample_zvals, sdf_to_sigma)"
BACKWARD = "autograd backward (train.backward)"
OPTIMIZER = "optimizer (train.optimizer)"

# the metrics the layer maps give, declared as BENCHMARK.json declares its own
METRICS = [
    spans_run._metric("sampler_ms.volsdf", "ms/step", "program_span", SAMPLER, "train_rays_per_s", VOLSDF),
    spans_run._metric("backward_ms.volsdf", "ms/step", "program_span", BACKWARD, "train_rays_per_s", VOLSDF),
    spans_run._metric("backward_ms.neus", "ms/step", "program_span", BACKWARD, "train_rays_per_s", NEUS),
    spans_run._metric("optimizer_ms.neus", "ms/step", "program_span", OPTIMIZER, "train_rays_per_s", NEUS),
]


def _with_spans(driver):
    """The SDF driver ``driver`` whose traced reading reaches the result
    line and whose window runs with spans on."""

    class SpansSdf(driver):
        top = "train.stride"

        def window(self, seconds):
            return spans_run._window_with_spans(self, seconds)

        def traced(self, reading):
            out = super().traced(reading)
            spans_run._READINGS.append(reading)
            return out

    return SpansSdf


def main(argv=None, out=None):
    spans.read_profiled = graph_spans.read_profiled
    spans_run.METRICS = spans_run.METRICS + METRICS
    spans_run.SPAN_KEYS = spans_run.SPAN_KEYS + ("span_unmapped_replays",)
    train_neus.DRIVER = _with_spans(train_neus.TrainingNeus)
    train_volsdf.DRIVER = _with_spans(train_volsdf.TrainingVolsdf)
    return spans_run.main(argv, out)


if __name__ == "__main__":
    sys.exit(main())
