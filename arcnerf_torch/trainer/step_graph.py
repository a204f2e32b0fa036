"""One batch bucket's optimizer step over static buffers: the port's form
of the JAX trainer's strided steps (``_scan_steps_impl``,
``_scan_sampled_impl``), where ``lax.scan`` runs a stride of steps in one
dispatch and one executable is compiled for each batch bucket.

A ``StepGraph`` holds, for one bucket of n_rays rays:

- the batch: drawn inside the step from the device pool
  (``Pipeline.sample``), or, in the fed form, a static buffer that each
  step's batch is copied into before the step;
- a ring of the per-step stats (``loss``, each ``loss/*``, ``psnr``,
  ``n_valid_pts``) and, when the step draws its batch, of its ray picks,
  written at index t of the stride on the device;
- on CUDA, the step captured as a CUDA graph.

On CUDA the first step at the bucket runs eagerly on a side stream (the
warm-up that PyTorch's whole-network capture asks for; it is a real,
counted step), then the step is captured with the trainer's generator
registered, so that replays draw what eager steps would draw, and every
later step is one replay. A failure to capture or replay raises; nothing
falls back to the eager step. On the CPU the same function runs on the
same buffers, one call a step.

The graph reads the parameters, the Adam state, the EMA shadows, the
occupancy state and the rate by address: whoever replaces one of those
tensors (rather than writing into it) drops the trainer's graphs. The
kernels' launch counters count Python calls, so each counts a bucket's
warm-up and capture and no replay. The capture records the step's layer
map (``profiler.capturing``), which each replay's span names.
"""

import time

import torch

from ..utils import profiler


class StepGraph:

    def __init__(self, trainer, n_rays, capacity, feed=None):
        """``feed``: a step's batch (dict of (1, n_rays, ...) tensors) for
        the fed form, else None (the step draws its batch). ``capacity``:
        the longest stride the ring holds."""
        self.trainer = trainer
        self.n_rays, self.capacity = int(n_rays), int(capacity)
        dev = trainer.device
        self.batch = None if feed is None else {k: torch.empty(v.shape, dtype=v.dtype, device=dev)
                                                for k, v in feed.items()}
        self.picks = None if feed is not None else torch.zeros((self.capacity, self.n_rays), dtype=torch.int64,
                                                               device=dev)
        self.slot = torch.zeros((), dtype=torch.int64, device=dev)
        self.ring = None  # made at the first step, from its stats
        self.graph = None
        self.graph_id = None  # the layer map's name (profiler.capturing)
        self.capture_seconds = self.map_seconds = None

    def _step(self):
        """One optimizer step; its stats (and picks) go to ring slot t."""
        trainer = self.trainer
        slot = self.slot.view(1)
        if self.picks is None:
            batch = self.batch
        else:
            batch = trainer.pipeline.sample(trainer.generator)
            self.picks.index_copy_(0, slot, trainer.pipeline.last_picks[None])
        stats = trainer.update(batch)
        if self.ring is None:
            self.ring = {k: torch.zeros((self.capacity,), dtype=v.dtype, device=v.device) for k, v in stats.items()}
        for k, v in stats.items():
            self.ring[k].index_copy_(0, slot, v.reshape(1))
        self.slot.add_(1)

    def _warm_up_and_capture(self):
        dev = self.trainer.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._step()
        torch.cuda.current_stream(dev).wait_stream(side)
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.trainer.generator)
        nodes = profiler.CaptureNodes(dev)
        with torch.cuda.graph(graph), profiler.capturing("train.step", nodes) as layers:
            self._step()
        torch.cuda.synchronize(dev)
        self.capture_seconds = time.perf_counter() - t0
        self.graph, self.graph_id, self.map_seconds = graph, layers.graph, layers.seconds
        self.trainer.logger.add_log("Captured the training step at {} rays in {:.3f} s (its layer map {:.2f} ms)"
                                    .format(self.n_rays, self.capture_seconds, 1e3 * self.map_seconds))

    def run(self, n, feeds=None):
        """``n`` consecutive steps (``feeds``: their batches, in the fed
        form). Returns the n steps' stats as (n,) tensors (a copy)."""
        if n > self.capacity:
            raise ValueError("a stride of {} steps exceeds the ring of {}".format(n, self.capacity))
        if (feeds is None) != (self.batch is None) or (feeds is not None and len(feeds) != n):
            raise ValueError("the fed form takes one batch a step")
        self.slot.zero_()
        on_card = self.trainer.device.type == "cuda"
        for t in range(n):
            if feeds is not None:
                for k, v in feeds[t].items():
                    self.batch[k].copy_(v)
            if not on_card:
                self._step()
            elif self.graph is None:
                with profiler.span("train.capture", rays=self.n_rays):
                    self._warm_up_and_capture()
            else:
                with profiler.span("train.replay", graph=self.graph_id):
                    self.graph.replay()
        return {k: v[:n].clone() for k, v in self.ring.items()}
