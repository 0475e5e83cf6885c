"""Run provenance, disk-space guard, and email alert hooks.

Port of isca_tpu/utils/alerts.py: the counterparts of the reference's
run-layer utilities:
  * git provenance dump — codebase.py:153-183 `write_source_control_status`
    (commit hash + dirty status + diff written per run so any output can be
    traced to exact source).
  * disk-space guard — isca/check_disk_space.py `disk_usage` +
    create_alert.py `disk_space_alert` (warn below `limit_gb`, abort below
    `cutoff_gb` so a filling scratch disk cannot corrupt a long run).
  * email alerts — isca/send_email.py (SMTP); here a thin seam that is easy
    to monkeypatch/test and is wired through the Experiment event bus
    (EventEmitter 'run:failed' / 'disk:low' hooks) rather than called
    directly from the run loop.
"""

from __future__ import annotations

import logging
import os
import shutil
import subprocess

log = logging.getLogger("isca_tpu_torch")


# ---------------------------------------------------------------------------
# Provenance (write_source_control_status)
# ---------------------------------------------------------------------------

def _git(repo_dir, *args) -> str:
    try:
        out = subprocess.run(
            ["git", "-C", repo_dir, *args],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip() if out.returncode == 0 else ""
    except (OSError, subprocess.TimeoutExpired):
        return ""


def source_control_status(repo_dir: str | None = None) -> dict:
    """Commit hash, branch, and dirty state of the framework source tree."""
    if repo_dir is None:
        repo_dir = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
    commit = _git(repo_dir, "log", "-1", "--format=%H")
    if not commit:
        return {"commit": "unknown", "branch": "", "dirty": [], "diff": ""}
    status = _git(repo_dir, "status", "-b", "--porcelain")
    dirty = [ln for ln in status.splitlines()[1:] if ln.strip()]
    diff = _git(repo_dir, "diff", "--no-color") if dirty else ""
    return {
        "commit": commit,
        "branch": status.splitlines()[0].lstrip("# ") if status else "",
        "dirty": dirty,
        "diff": diff,
    }


def write_source_control_status(outfile: str, repo_dir: str | None = None) -> dict:
    """Render the reference's git_hash_used.txt format (codebase.py:157-183)."""
    s = source_control_status(repo_dir)
    with open(outfile, "w") as f:
        f.write("*---commit hash used for isca_tpu_torch code in workdir---*:\n")
        f.write(s["commit"])
        if s["branch"]:
            f.write(f"\n\nbranch: {s['branch']}\n")
        if s["dirty"]:
            f.write("\n#### Run from dirty commit ####\n")
            f.write("*---git status output---*:\n")
            f.write("\n".join(s["dirty"]))
            f.write("\n\n*---git diff output---*\n")
            f.write(s["diff"])
        f.write("\n")
    return s


# ---------------------------------------------------------------------------
# Disk-space guard (check_disk_space.py + create_alert.py)
# ---------------------------------------------------------------------------

class DiskSpaceError(IOError):
    """Free space fell below the hard cutoff; the run must stop."""


def disk_usage(path: str):
    """(total, used, free) in bytes (shutil covers the reference's statvfs)."""
    return shutil.disk_usage(path)


def check_disk_space(path: str, limit_gb: float = 20.0,
                     cutoff_gb: float = 5.0, emitter=None,
                     context: str = "") -> float:
    """Warn below limit_gb free, raise DiskSpaceError below cutoff_gb.

    Returns free space in GB. Emits 'disk:low' on the optional emitter so
    user alert hooks (e.g. email) fire (create_alert.py semantics).
    """
    free_gb = disk_usage(path).free / 1e9
    if free_gb < cutoff_gb:
        msg = (f"Disk space {free_gb:.1f} GB below hard cutoff "
               f"{cutoff_gb:.1f} GB {context}; aborting run")
        if emitter is not None:
            emitter.emit("disk:low", path, free_gb, True)
        raise DiskSpaceError(msg)
    if free_gb < limit_gb:
        log.warning("Disk space %.1f GB below %.1f GB %s",
                    free_gb, limit_gb, context)
        if emitter is not None:
            emitter.emit("disk:low", path, free_gb, False)
    return free_gb


# ---------------------------------------------------------------------------
# Email alerts (send_email.py)
# ---------------------------------------------------------------------------

def send_email(recipient: str, message: str, subject: str = "isca_tpu_torch alert",
               sender: str = "isca_tpu_torch@localhost",
               smtp_host: str = "localhost", smtp_port: int = 25) -> bool:
    """Send a plain-text alert email; returns False (and logs) on failure
    instead of raising — an unreachable mail host must not kill a run."""
    import smtplib
    from email.message import EmailMessage

    msg = EmailMessage()
    msg["From"], msg["To"], msg["Subject"] = sender, recipient, subject
    msg.set_content(message)
    try:
        with smtplib.SMTP(smtp_host, smtp_port, timeout=10) as s:
            s.send_message(msg)
        return True
    except OSError as e:
        log.warning("alert email to %s failed: %s", recipient, e)
        return False


def email_on_failure(exp, recipient: str, **smtp_kw):
    """Attach an email hook to an Experiment: mails on 'run:failed' and on
    'disk:low' (util.py email_alerts / create_alert.py role)."""
    exp.on("run:failed",
           lambda e, i, *a: send_email(
               recipient, f"experiment {e.name} segment {i} FAILED", **smtp_kw))
    exp.on("disk:low",
           lambda path, free_gb, fatal: send_email(
               recipient,
               f"disk space low: {free_gb:.1f} GB free at {path}"
               + (" (run aborted)" if fatal else ""), **smtp_kw))
    return exp
