"""Overlapped serving feeder: host decode and packing run while the device
runs earlier batches (counterpart of ``applecider_tpu/infer/feeder.py``).

::

  workers           decode stamps + assemble samples + pack
  (threads or       (+ the copy to the device in thread mode)
   processes)            │  bounded buffer of prepared batches
  main thread       ``run_placed`` + resolve, ``depth`` batches in flight

A batch's stamps decode in one call of the native decoder
(``native.decode_stamps_batch``), during which ctypes releases the GIL: so
in thread mode the workers' decodes overlap each other and the main
thread's launches. Process mode moves decode
and packing to spawned worker processes, which never touch CUDA: they pack
with ``infer.stream.pack_compact`` (the host half of
``FusedSpectraStream.place``) and the main process copies with
``place_packed`` and enqueues. A router without
``place_packed`` (``RoutedAlertStream``) gets assembled samples from the
workers and packs them in the main process.

Outputs are the underlying router's, batch for batch.

Two faults of the reference are fixed here: a record whose ``stamps`` does
not hold exactly three blobs raises, naming the record, instead of
misattributing a later decode failure; and the process workers pack with
the router's own ``spec_buckets`` instead of a copied default.
"""

from __future__ import annotations

import math
from collections import deque
from typing import Callable, Iterable, Iterator, Optional

import numpy as np

from applecider_tpu_torch.infer.stream import pack_compact
from applecider_tpu_torch.native import decode_stamps_batch


def assemble_samples(records: list[dict], hw: int = 63) -> list[dict]:
    """Raw alert records -> ``pack_alert_batch`` sample dicts.

    A record is a pack sample whose ``image`` may instead be ``stamps``:
    a list of 3 gzipped-FITS byte blobs (science/template/difference, the
    ZTF alert layout), decoded here into the (hw, hw, 3) image; all the
    records' stamps decode in one native call. Raises ``ValueError`` naming
    the record when it does not hold 3 blobs or one of them does not decode
    to (hw, hw).
    """
    blobs, owners = [], []
    for i, r in enumerate(records):
        if "stamps" not in r:
            continue
        if len(r["stamps"]) != 3:
            raise ValueError(f"record {i} has {len(r['stamps'])} stamps; a ZTF alert carries 3 "
                             "(science, template, difference)")
        owners.append(i)
        blobs.extend(r["stamps"])
    out = [dict(r) for r in records]
    if owners:
        images, ok = decode_stamps_batch(blobs, hw=hw)
        if not ok.all():
            bad = int(np.flatnonzero(~ok)[0])
            raise ValueError(
                f"stamp decode failed for blob {bad} (record {owners[bad // 3]}); "
                "undecodable cutouts must be filtered or substituted upstream")
        for j, i in enumerate(owners):
            del out[i]["stamps"]
            out[i]["image"] = np.stack(list(images[3 * j:3 * j + 3]), axis=-1)
    return out


class OverlappedServingFeeder:
    """Pipeline raw-record batches through decode/pack workers and the
    device.

    Parameters
    ----------
    router : FusedSpectraStream | RoutedAlertStream
        The serving router (its ``place``/``run_placed`` API).
    n_workers : int
        Decode+pack workers.
    depth : int
        Enqueued-but-unresolved batches kept in flight on the device.
    buffer : int
        Prepared batches buffered between workers and the device.
    mode : "thread" | "process"
        Thread workers share the process; process workers are spawned and
        pack on the host only (one pickle per packed batch).
    """

    def __init__(self, router, n_workers: int = 2, depth: int = 3, buffer: int = 4,
                 mode: str = "thread", length_buckets: Optional[tuple] = None, hw: int = 63):
        if mode not in ("thread", "process"):
            raise ValueError(f"mode must be thread|process, got {mode!r}")
        self.router = router
        self.n_workers = int(n_workers)
        self.depth = int(depth)
        self.buffer = int(buffer)
        self.mode = mode
        self.length_buckets = length_buckets
        self.hw = int(hw)

    def _prepare_thread(self, records):
        """Thread worker: decode + pack + copy to the device."""
        samples = assemble_samples(records, hw=self.hw)
        return self.router.place(samples, length_buckets=self.length_buckets)

    def serve(self, record_batches: Iterable[list],
              on_result: Optional[Callable] = None) -> Iterator[np.ndarray]:
        """Yield one ``(n, C)`` probability array per input batch, in order.

        Consumes ``record_batches`` lazily, so an unbounded stream works;
        keeps ``buffer`` prepared batches and ``depth`` enqueued batches in
        flight. ``on_result`` (optional) is called with each resolved array
        as soon as it is read back (same thread).
        """
        if self.mode == "process":
            import multiprocessing as mp
            from concurrent.futures import ProcessPoolExecutor

            host_pack = hasattr(self.router, "place_packed")
            # spawn: a forked worker would inherit the parent's CUDA context
            executor = ProcessPoolExecutor(max_workers=self.n_workers,
                                           mp_context=mp.get_context("spawn"))
            if host_pack:
                def submit(rb):
                    return executor.submit(_pack_worker, rb, self.length_buckets, self.hw,
                                           self.router.spec_buckets)

                def place(payload):
                    return self.router.place_packed(payload)
            else:
                def submit(rb):
                    return executor.submit(assemble_samples, rb, self.hw)

                def place(payload):
                    return self.router.place(payload, length_buckets=self.length_buckets)
        else:
            from concurrent.futures import ThreadPoolExecutor

            executor = ThreadPoolExecutor(max_workers=self.n_workers)

            def submit(rb):
                return executor.submit(self._prepare_thread, rb)

            def place(payload):
                return payload

        with executor:
            prep: deque = deque()  # (future, n)
            disp: deque = deque()  # (n, resolver)

            def promote():
                fut, n = prep.popleft()
                disp.append((n, self.router.run_placed(place(fut.result()))))

            def drain_one():
                n, resolver = disp.popleft()
                out = resolver()[:n]
                if on_result is not None:
                    on_result(out)
                return out

            for rb in record_batches:
                prep.append((submit(rb), len(rb)))
                # promote every finished prepared batch (or block when the
                # buffer is full) to the device
                while prep and (prep[0][0].done() or len(prep) > self.buffer):
                    promote()
                while len(disp) > self.depth:
                    yield drain_one()
            while prep:
                promote()
                while len(disp) > self.depth:
                    yield drain_one()
            while disp:
                yield drain_one()


def _pack_worker(records, length_buckets, hw, spec_buckets):
    """Process-pool body: decode + assemble + host pack with the router's
    ``spec_buckets``, no CUDA."""
    return pack_compact(assemble_samples(records, hw=hw), spec_buckets,
                        length_buckets=length_buckets)


def pipeline_model(host_per_core_alerts_per_sec: float,
                   device_alerts_per_sec: float,
                   n_cores: int,
                   h2d_alerts_per_sec: Optional[float] = None) -> dict:
    """Steady-state rate model for the overlapped pipeline.

    With decode+pack spread over ``n_cores`` workers and overlapped with
    the copy and the device, the sustained rate is the slowest stage's;
    ``cores_to_saturate`` is how many host cores a deployment needs before
    the device (or the link) binds.
    """
    host = host_per_core_alerts_per_sec * max(n_cores, 1)
    stages = {"host": host, "device": device_alerts_per_sec}
    if h2d_alerts_per_sec:
        stages["h2d"] = h2d_alerts_per_sec
    binding = min(stages, key=stages.get)
    non_host = min(v for k, v in stages.items() if k != "host")
    return {
        "projected_alerts_per_sec": round(min(stages.values()), 1),
        "binding_stage": binding,
        "cores_to_saturate": math.ceil(non_host / host_per_core_alerts_per_sec),
    }
