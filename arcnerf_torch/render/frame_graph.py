"""The exact render tier's chunk loop over one frame shape as one CUDA
graph: the port's form of the JAX engine's one jitted dispatch over a
static budget of ray chunks a frame.

A ``FrameGraph`` holds, for one frame shape (its rays, the rays a chunk,
and the keys the frame feeds: ``rays_o``, ``rays_d``, and ``bkg_color``
when a background is fed):

- static input buffers of the frame's (n, ...) tensors, which each frame's
  rays are copied into (device to device);
- the loop's outputs (every per-ray output as an (n, ...) tensor, each
  chunk's written into its rows, and each chunk's ``n_valid_pts``);
- the whole loop, every chunk's model call and its rows' copies, captured
  as one CUDA graph.

The first frame at a shape runs the loop eagerly on a side stream (the
warm-up that PyTorch's whole-network capture asks for; it also makes the
device constants the loop reads), then captures it, then replays it; every
later frame is one replay, and its outputs are copied out of the static
buffers. A failure to capture or replay raises; nothing falls back to the
eager loop. Warm-up and capture record and count nothing while tracing is
on (``profiler.suspended``); each replay counts the chunks it rendered
(``render.replays``) and, from the chunks' static valid counts, the
counters the eager chunks count (``FgModel.count_stream``). Graphs are
captured on CUDA devices alone (``captures_on``): elsewhere the engine runs
the loop itself.

The graph reads the parameters, the buffers and the occupancy state by
address, and bakes the render settings in at capture: the engine drops its
graphs when one of those tensors is replaced and in ``set_render_cap``.
The kernels' launch counters count Python calls, so each counts a shape's
warm-up and capture and no replay.
"""

import time

import torch

from ..utils import profiler


class FrameGraph:

    @staticmethod
    def captures_on(device):
        """Whether frames on ``device`` (a torch.device) render through a
        graph."""
        return device.type == "cuda"

    def __init__(self, engine, feed, chunk_rays):
        """``feed``: the first frame's rays (dict of (n, ...) tensors),
        whose shapes and dtypes the buffers take; ``chunk_rays``: the rays
        of every chunk but the last."""
        self.engine = engine
        self.n_rays, self.chunk_rays = int(feed["rays_o"].shape[0]), int(chunk_rays)
        self.n_chunks = -(-self.n_rays // self.chunk_rays)
        self.inputs = {k: torch.empty(v.shape, dtype=v.dtype, device=v.device) for k, v in feed.items()}
        self.out = None
        self.graph = None
        self.capture_seconds = None

    def _render(self):
        return self.engine._chunk_loop(self.inputs, self.chunk_rays)

    def _warm_up_and_capture(self):
        dev = self.inputs["rays_o"].device
        with profiler.suspended():
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                self._render()
            torch.cuda.current_stream(dev).wait_stream(side)
            t0 = time.perf_counter()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                self.out = self._render()
            torch.cuda.synchronize(dev)
        self.capture_seconds = time.perf_counter() - t0
        self.graph = graph

    def _count(self, n_valid):
        """The counters of the replayed chunks, by chunk size (tracing on)."""
        fg = self.engine.model.fg_model
        full = self.n_rays // self.chunk_rays
        profiler.count("render.replays", self.n_chunks)
        if full:
            fg.count_stream(n_valid[:full], self.chunk_rays)
        if full < self.n_chunks:
            fg.count_stream(n_valid[full:], self.n_rays - full * self.chunk_rays)

    def run(self, feed):
        """The frame of ``feed`` (the buffers' shapes): (per-ray outputs as
        (n, ...) tensors, each chunk's valid-sample count (n_chunks,)),
        the caller's to keep."""
        for k, v in feed.items():
            self.inputs[k].copy_(v)
        if self.graph is None:
            with profiler.span("render.capture", rays=self.n_rays, chunks=self.n_chunks):
                self._warm_up_and_capture()
            profiler.count("render.captures", 1)
        with profiler.span("render.replay", rays=self.n_rays, chunks=self.n_chunks):
            self.graph.replay()
        flat, n_valid = self.out
        if profiler.active():
            self._count(n_valid)
        return {k: v.clone() for k, v in flat.items()}, n_valid.clone()
