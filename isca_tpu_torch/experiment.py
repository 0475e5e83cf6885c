"""Experiment runner: segmented runs, diagnostics, restart chaining.

Port of isca_tpu/experiment.py, the user-facing replacement for the
reference's Python `Experiment` (src/extra/python/isca/experiment.py): no
compile step, no MPI spawn, no per-PE output combining. A run is a sequence
of segments (e.g. 30-day months); each segment steps the model in a Python
loop with the diagnostics accumulated on the model's device, writes NetCDF
diagnostics, and archives a restart that the next segment (or a later
`run(i)`) chains from. Restarts are in isca_tpu's format, so a segment can
chain from one that isca_tpu wrote.

    model = HeldSuarezModel(HeldSuarezConfig())           # on the card
    dt = DiagTable().add_file("atmos_daily", 86400)
    dt.add_field("atmos_daily", "dynamics", "temp", time_avg=True)
    exp = Experiment("held_suarez_T42", model, dt, datadir="runs")
    exp.run(1, days=30)
    exp.run(2, days=30)          # chains from run 1's restart

The model carries its device; `Experiment` takes none.
"""

from __future__ import annotations

import json
import logging
import os
import time as _time

import numpy as np
import torch

from isca_tpu_torch.io.diag_manager import DiagManager, DiagTable
from isca_tpu_torch.io.restart import load_restart, save_restart
from isca_tpu_torch.utils.events import EventEmitter, FailedRunError

log = logging.getLogger("isca_tpu_torch")
if not log.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("%(asctime)s isca_tpu_torch: %(message)s"))
    log.addHandler(_h)
    log.setLevel(logging.INFO)


class Experiment(EventEmitter):
    """Lifecycle events ('run:ready', 'run:progress', 'run:complete',
    'run:failed' - experiment.py:300-353 equivalents) can be hooked with
    `exp.on(event, fn)`.  With `json_logging=True`, per-chunk global
    integrals from `model.diagnostics()` are appended to run{i}/steps.jsonl
    (spectral_dynamics_nml json_logging + print_interval global-integral
    prints, spectral_dynamics.F90:203, 1869-1912)."""

    def __init__(self, name: str, model, diag_table: DiagTable | None = None,
                 datadir: str = "runs", json_logging: bool = False,
                 disk_limit_gb: float | None = None,
                 disk_cutoff_gb: float = 5.0,
                 profile: bool = False):
        super().__init__()
        self.name = name
        self.model = model
        self.datadir = os.path.join(datadir, name)
        self.diag_table = diag_table
        self.json_logging = json_logging
        # profile=True wraps each segment in a torch.profiler trace written
        # to run{i}/profile/trace.json (chrome://tracing or Perfetto): the
        # mpp_clock equivalent for device op timings; utils/clocks.py covers
        # host phases. The ranges "dft", "legendre" and "implicit" annotate
        # the dycore's stages.
        self.profile = profile
        # disk guard (check_disk_space.py / create_alert.py): warn below
        # disk_limit_gb free, abort below disk_cutoff_gb, checked per segment
        self.disk_limit_gb = disk_limit_gb
        self.disk_cutoff_gb = disk_cutoff_gb
        os.makedirs(os.path.join(self.datadir, "restarts"), exist_ok=True)
        core = getattr(model, "core", None)
        self.T = core.T if core is not None else model.T
        self.dt = self._model_dt()
        self.steps_per_day = int(round(86400.0 / self.dt))

    def _model_dt(self):
        cfg = self.model.config
        return getattr(cfg, "dt", None) or cfg.core.dt

    def _restart_path(self, i: int) -> str:
        return os.path.join(self.datadir, "restarts", f"res{i:04d}.npz")

    def _sync(self):
        if self.model.device.type == "cuda":
            torch.cuda.synchronize(self.model.device)

    def derive(self, name: str, model=None, diag_table=None) -> "Experiment":
        """A derived experiment sharing this one's configuration but with a
        new name (and optionally a different model/diag table) — the
        reference's Experiment.derive (experiment.py:366-373)."""
        return Experiment(
            name, model or self.model,
            diag_table if diag_table is not None else self.diag_table,
            datadir=os.path.dirname(self.datadir) or ".",
            json_logging=self.json_logging,
            disk_limit_gb=self.disk_limit_gb,
            disk_cutoff_gb=self.disk_cutoff_gb,
        )

    def prune_restarts(self, keep_every: int = 12, keep_last: int = 1) -> list[str]:
        """Delete intermediate restart archives, keeping every `keep_every`-th
        segment and the most recent `keep_last` (isca/util.py:86-206
        restart-pruning utilities). Returns the deleted paths."""
        rdir = os.path.join(self.datadir, "restarts")
        files = sorted(f for f in os.listdir(rdir)
                       if f.startswith("res") and f.endswith(".npz"))
        deleted = []
        keep_tail = set(files[-keep_last:]) if keep_last > 0 else set()
        for f in files:
            idx = int(f[3:7])
            if f in keep_tail or (keep_every > 0 and idx % keep_every == 0):
                continue
            path = os.path.join(rdir, f)
            os.remove(path)
            deleted.append(path)
        return deleted

    # ------------------------------------------------------------------
    def run(self, i: int, days: int = 30, restart_file: str | None = None):
        """Run segment i for `days` model days; chain from res{i-1} if present."""
        model, T = self.model, self.T
        rundir = os.path.join(self.datadir, f"run{i:04d}")
        os.makedirs(rundir, exist_ok=True)

        # provenance + disk guard before any compute (codebase.py:153-183,
        # create_alert.py)
        from isca_tpu_torch.utils.alerts import check_disk_space, write_source_control_status
        write_source_control_status(os.path.join(rundir, "git_hash_used.txt"))
        if self.disk_limit_gb is not None:
            check_disk_space(self.datadir, self.disk_limit_gb,
                             self.disk_cutoff_gb, emitter=self,
                             context=f"before segment {i} of {self.name}")

        first = True
        state = model.initial_state()
        src = restart_file or (self._restart_path(i - 1) if i > 1 else None)
        if src and os.path.exists(src):
            state = load_restart(src, state)
            first = False
            log.info("segment %d: restarting from %s", i, src)
        elif i > 1:
            raise FileNotFoundError(f"no restart found for segment {i}: {src}")

        dm = None
        diag_state = None
        if self.diag_table is not None and self.diag_table.files:
            p_full_hpa = None
            p_half_hpa = None
            core = getattr(model, "core", None)
            if core is None and hasattr(model, "pk"):
                core = model          # column model carries pk/bk itself
            if core is not None and (hasattr(core, "pk_np")
                                     or hasattr(core, "pk")):
                ps0 = 1.0e5
                if hasattr(core, "pk_np"):
                    ph = core.pk_np + core.bk_np * ps0
                else:
                    ph = core.pk.cpu().numpy() + core.bk.cpu().numpy() * ps0
                p_half_hpa = ph / 100.0
                p_full_hpa = 0.5 * (ph[1:] + ph[:-1]) / 100.0
            dm = DiagManager(
                self.diag_table,
                np.degrees(T.lats.cpu().numpy()), np.degrees(T.lons.cpu().numpy()),
                p_full_hpa, p_half_hpa, outdir=rundir,
            )
            sample = self.model.diag_fields(state)
            diag_state = dm.init_state(sample)

        # one chunk of steps per diagnostic interval (or per day)
        freqs = [f.output_freq_seconds for f in (self.diag_table.files.values() if self.diag_table else [])]
        chunk_seconds = min(freqs) if freqs else 86400
        steps_per_chunk = max(1, int(round(chunk_seconds / self.dt)))
        total_steps = int(round(days * 86400.0 / self.dt))
        n_chunks = max(1, total_steps // steps_per_chunk)

        def chunk(state, diag_state, first):
            """steps_per_chunk steps, the first a forward step if `first`;
            the host does not wait for the device."""
            for k in range(steps_per_chunk):
                state = model.step(state, first=first and k == 0)
                if diag_state is not None:
                    diag_state = dm.update(diag_state, model.diag_fields(state))
            return state, diag_state

        jlog = None
        if self.json_logging and hasattr(model, "diagnostics"):
            jlog = open(os.path.join(rundir, "steps.jsonl"), "w")

        # valid-range guard (spectral_dynamics.F90:940-1005): checked once
        # per chunk AFTER diagnostics are flushed, so partial output survives
        # the abort — the reference's graceful_shutdown contract.
        vfn = model.validity if hasattr(model, "validity") else None

        self.emit("run:ready", self, i)
        t0 = _time.time()
        seconds_done = 0.0
        prof = None
        if self.profile:
            from torch.profiler import ProfilerActivity, profile

            prof_dir = os.path.join(rundir, "profile")
            os.makedirs(prof_dir, exist_ok=True)
            activities = [ProfilerActivity.CPU]
            if model.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            prof = profile(activities=activities)
            prof.__enter__()
            log.info("segment %d: tracing to %s", i, prof_dir)
        try:
            for ic in range(n_chunks):
                state, diag_state = chunk(state, diag_state, first and ic == 0)
                seconds_done += steps_per_chunk * self.dt
                time_days = ((i - 1) * days) + seconds_done / 86400.0
                # the host reads from the device here, once per chunk: the
                # flush, the validity verdict and the JSON scalars
                if dm is not None:
                    diag_state = dm.flush(diag_state, time_days, segment_label="")
                if vfn is not None:
                    rep = vfn(state)
                    if not bool(rep.ok):
                        from isca_tpu_torch.utils.validity import describe_violation
                        lo, hi = model.validity_range
                        msg = describe_violation(
                            model.validity_name, rep, lo, hi,
                            lats=getattr(T, "lats", None),
                            lons=getattr(T, "lons", None))
                        raise FailedRunError(
                            f"segment {i} at day {time_days:.2f}: {msg}")
                if jlog is not None:
                    scalars = {
                        k: float(v)
                        for k, v in model.diagnostics(state).items()
                        if np.ndim(v) == 0
                    }
                    if not np.all(np.isfinite(list(scalars.values()))):
                        raise FailedRunError(
                            f"segment {i}: non-finite diagnostics at day "
                            f"{time_days:.2f}: {scalars}")
                    jlog.write(json.dumps(
                        {"segment": i, "day": time_days, **scalars}) + "\n")
                    jlog.flush()
                self.emit("run:progress", self, i, time_days)
            self._sync()
        except Exception:
            self.emit("run:failed", self, i)
            raise
        finally:
            if prof is not None:
                prof.__exit__(None, None, None)
                prof.export_chrome_trace(os.path.join(prof_dir, "trace.json"))
            if jlog is not None:
                jlog.close()
            # scipy writes a NetCDF file when it is closed: close on an abort
            # too, so the records flushed before it are on disk
            if dm is not None:
                dm.close()
        wall = _time.time() - t0
        log.info(
            "segment %d: %d days in %.1fs (%.0f model-days/day)",
            i, days, wall, days * 86400.0 / max(wall, 1e-9),
        )

        save_restart(self._restart_path(i), state)
        with open(os.path.join(rundir, "provenance.json"), "w") as f:
            json.dump({"segment": i, "days": days, "dt": self.dt,
                       "wall_seconds": wall}, f)
        self.emit("run:complete", self, i)
        return state
