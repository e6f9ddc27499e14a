"""A thread that reads the main thread's stack every 10 ms
and charges the time since its last look to a layer: the innermost
function on the stack that one of the cell's metric readers maps to
its layer (`FUNCTIONS`: (module, qualified name) pairs of the port).
A wait on the card inside a layer is that layer's time, since the
frame waits there. It also keeps a timeline of the innermost port
function on the stack, which names what the host did during the
device's idle gaps."""
from __future__ import annotations

import sys
import threading
import time

PORT = "cupoch_tpu_torch"


class StackSampler:
    def __init__(self, mapping: dict, interval_s: float = 1e-2,
                 thread_id: int = None):
        """mapping: {(module, qualname): metric name}."""
        self.mapping = mapping
        self.interval = interval_s
        self.tid = thread_id or threading.main_thread().ident
        self.seconds = {name: 0.0 for name in set(mapping.values())}
        self.timeline = []          # (perf_counter, innermost port fn)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self):
        self._last = time.perf_counter()
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=10.0)
        if self._thread.is_alive():
            raise RuntimeError("the stack sampler did not stop")

    def classify(self, frame):
        """(metric of the innermost mapped function, innermost port
        function) on the stack that ends at `frame`."""
        metric = port_fn = None
        while frame is not None:
            mod = frame.f_globals.get("__name__", "")
            if mod.split(".")[0] == PORT:
                name = frame.f_code.co_qualname
                if port_fn is None:
                    port_fn = f"{mod}.{name}"
                metric = self.mapping.get((mod, name))
                if metric is not None:
                    break
            frame = frame.f_back
        return metric, port_fn

    def _run(self):
        while not self._stop.wait(self.interval):
            now = time.perf_counter()
            frame = sys._current_frames().get(self.tid)
            metric, port_fn = self.classify(frame)
            if metric is not None:
                self.seconds[metric] += now - self._last
            self.timeline.append((now, port_fn))
            self._last = now


def mapping_of(readers: dict) -> dict:
    """{(module, qualname): metric} from {metric: reader module}."""
    out = {}
    for name, mod in readers.items():
        for fn in getattr(mod, "FUNCTIONS", ()):
            out[tuple(fn)] = name
    return out
