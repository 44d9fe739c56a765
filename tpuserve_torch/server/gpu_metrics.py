"""The card's own gauges on ``/metrics``, from NVML: the port of the
embedded mode of ``tpuserve/server/tpu_metrics.py``.

The reference's observability stack scrapes NVIDIA's DCGM exporter
(``DCGM_FI_DEV_GPU_UTIL``, ``DCGM_FI_DEV_FB_USED`` ...) through a
ServiceMonitor at a 5 s cadence; the JAX package published TPU analogs of
those gauges from inside the engine process.  On an NVIDIA card the
engine process reads NVIDIA's NVML library (``libnvidia-ml.so.1``,
through ``ctypes``: no ``pynvml`` needed) every ``interval_s`` on a
collector thread and exports the gauges under the DCGM exporter's own
names and labels (``gpu``, ``modelName``), so its dashboards read them
unchanged:

- ``DCGM_FI_DEV_COUNT``: cards NVML sees;
- ``DCGM_FI_DEV_FB_USED`` / ``DCGM_FI_DEV_FB_TOTAL``: frame-buffer MiB used
  and total (``nvmlDeviceGetMemoryInfo``);
- ``DCGM_FI_DEV_GPU_UTIL``: NVML's utilisation, percent;
- ``DCGM_FI_DEV_POWER_USAGE`` / ``DCGM_FI_DEV_ENFORCED_POWER_LIMIT``: watts;
- ``gpu_duty_cycle_percent``: the engine's own duty cycle, the share of
  wall time its steps took since the last collection (``record_busy``,
  fed by the runner), beside NVML's sampled one, as the JAX exporter
  keeps its step-time duty cycle.

Without the library (a machine with no NVIDIA GPU) the constructor
raises ``OSError``; the server logs it and serves without these gauges.
The node-level DaemonSet mode is the DCGM exporter's own job on a GPU
node (ROADMAP.md A11).
"""

from __future__ import annotations

import ctypes
import logging
import threading
import time

logger = logging.getLogger("tpuserve_torch.gpu_metrics")

NVML_LIB = "libnvidia-ml.so.1"
_MIB = 1 << 20


class _Memory(ctypes.Structure):
    _fields_ = [("total", ctypes.c_ulonglong), ("free", ctypes.c_ulonglong),
                ("used", ctypes.c_ulonglong)]


class _Utilization(ctypes.Structure):
    _fields_ = [("gpu", ctypes.c_uint), ("memory", ctypes.c_uint)]


class Nvml:
    """The few NVML calls the exporter makes; raises ``OSError`` when the
    library is missing or a call fails."""

    def __init__(self, lib: str = NVML_LIB):
        self._lib = ctypes.CDLL(lib)
        self._check(self._lib.nvmlInit_v2(), "nvmlInit_v2")

    def _check(self, rc: int, what: str) -> None:
        if rc != 0:
            raise OSError(f"NVML {what} failed with code {rc}")

    def count(self) -> int:
        n = ctypes.c_uint()
        self._check(self._lib.nvmlDeviceGetCount_v2(ctypes.byref(n)), "nvmlDeviceGetCount_v2")
        return n.value

    def handle(self, index: int):
        h = ctypes.c_void_p()
        self._check(self._lib.nvmlDeviceGetHandleByIndex_v2(ctypes.c_uint(index),
                                                              ctypes.byref(h)),
                    "nvmlDeviceGetHandleByIndex_v2")
        return h

    def name(self, h) -> str:
        buf = ctypes.create_string_buffer(96)
        self._check(self._lib.nvmlDeviceGetName(h, buf, ctypes.c_uint(96)), "nvmlDeviceGetName")
        return buf.value.decode(errors="replace")

    def memory(self, h) -> tuple[int, int]:
        """(used, total) bytes."""
        m = _Memory()
        self._check(self._lib.nvmlDeviceGetMemoryInfo(h, ctypes.byref(m)),
                    "nvmlDeviceGetMemoryInfo")
        return int(m.used), int(m.total)

    def utilization(self, h) -> int:
        u = _Utilization()
        self._check(self._lib.nvmlDeviceGetUtilizationRates(h, ctypes.byref(u)),
                    "nvmlDeviceGetUtilizationRates")
        return int(u.gpu)

    def power_w(self, h) -> tuple[float, float]:
        """(usage, enforced limit) watts."""
        use, lim = ctypes.c_uint(), ctypes.c_uint()
        self._check(self._lib.nvmlDeviceGetPowerUsage(h, ctypes.byref(use)),
                    "nvmlDeviceGetPowerUsage")
        self._check(self._lib.nvmlDeviceGetEnforcedPowerLimit(h, ctypes.byref(lim)),
                    "nvmlDeviceGetEnforcedPowerLimit")
        return use.value / 1000.0, lim.value / 1000.0


class GpuMetricsExporter:
    """The embedded exporter: NVML read every ``interval_s`` into gauges of
    ``registry`` (the server's ``ServerMetrics``), plus the engine's step
    duty cycle.  ``nvml``: an :class:`Nvml` (made here by default, which
    raises ``OSError`` without the library)."""

    def __init__(self, registry, interval_s: float = 5.0, nvml: Nvml | None = None):
        self.nvml = nvml or Nvml()
        self.interval_s = interval_s
        labels = ("gpu", "modelName")

        def gauge(name, doc, labelnames=labels):
            return registry.family(name, doc, "gauge", labelnames)

        self.device_count = gauge("DCGM_FI_DEV_COUNT", "Cards NVML sees", ()).labels()
        self.fb_used = gauge("DCGM_FI_DEV_FB_USED", "Frame buffer memory used (in MiB)")
        self.fb_total = gauge("DCGM_FI_DEV_FB_TOTAL", "Frame buffer memory total (in MiB)")
        self.gpu_util = gauge("DCGM_FI_DEV_GPU_UTIL", "GPU utilization (in %)")
        self.power = gauge("DCGM_FI_DEV_POWER_USAGE", "Power draw (in W)")
        self.power_limit = gauge("DCGM_FI_DEV_ENFORCED_POWER_LIMIT",
                                 "Enforced power limit (in W)")
        self.duty_cycle = gauge("gpu_duty_cycle_percent",
                                "Share of wall time the engine's steps took since the "
                                "previous collection (percent; NVML's sampled "
                                "utilization is DCGM_FI_DEV_GPU_UTIL)")
        self.readings: list[dict] = []     # the last collection, per card
        self.collections = 0
        self._busy_s = 0.0
        self._window_start = time.monotonic()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def collect_once(self) -> list[dict]:
        now = time.monotonic()
        window = max(now - self._window_start, 1e-6)
        duty = min(100.0 * self._busy_s / window, 100.0)
        self._busy_s = 0.0
        self._window_start = now
        n = self.nvml.count()
        self.device_count.set(n)
        readings = []
        for i in range(n):
            h = self.nvml.handle(i)
            name = self.nvml.name(h)
            used, total = self.nvml.memory(h)
            util = self.nvml.utilization(h)
            watts, limit = self.nvml.power_w(h)
            lab = {"gpu": str(i), "modelName": name}
            self.fb_used.labels(**lab).set(used / _MIB)
            self.fb_total.labels(**lab).set(total / _MIB)
            self.gpu_util.labels(**lab).set(util)
            self.power.labels(**lab).set(watts)
            self.power_limit.labels(**lab).set(limit)
            self.duty_cycle.labels(**lab).set(duty)
            readings.append({"gpu": i, "name": name, "fb_used_mib": used / _MIB,
                             "fb_total_mib": total / _MIB, "util_percent": util,
                             "power_w": watts, "power_limit_w": limit,
                             "duty_cycle_percent": duty})
        self.readings = readings
        self.collections += 1
        return readings

    def record_busy(self, seconds: float) -> None:
        """The runner's step wall seconds (``AsyncEngineRunner.on_step_time``)."""
        self._busy_s += seconds

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.collect_once()
            except Exception:
                logger.exception("NVML collection failed")
            self._stop.wait(self.interval_s)

    def start(self) -> threading.Thread:
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="tpuserve-torch-gpu-metrics")
        self._thread.start()
        return self._thread

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
