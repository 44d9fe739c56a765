"""Subprocess command runner with dry-run and fake injection points.

A copy of ``tpuserve/provision/runner.py``.  The reference drives
everything through ansible modules / ``shell:`` tasks (e.g.
deploy-k8s-cluster.sh:20,33,38 invoking ansible-playbook; raw kubectl and
helm shell tasks throughout kubernetes-single-node.yaml:286-292,325-330).
Here every external command goes through one seam so the whole pipeline is
unit-testable without cloud credentials — the "fake backend" the reference
never had (SURVEY.md §4).
"""

from __future__ import annotations

import dataclasses
import logging
import subprocess
import time
from typing import Callable, Optional, Sequence

logger = logging.getLogger("tpuserve_torch.provision")


@dataclasses.dataclass
class CommandResult:
    argv: tuple[str, ...]
    returncode: int
    stdout: str = ""
    stderr: str = ""

    @property
    def ok(self) -> bool:
        return self.returncode == 0


class CommandError(RuntimeError):
    def __init__(self, result: CommandResult):
        self.result = result
        super().__init__(
            f"command failed ({result.returncode}): {' '.join(result.argv)}\n"
            f"stdout: {result.stdout[-2000:]}\nstderr: {result.stderr[-2000:]}")


class CommandRunner:
    """Runs external commands (gcloud / kubectl / helm / curl).

    ``check=True`` mirrors the reference's ``set -e`` abort-on-failure
    semantics (deploy-k8s-cluster.sh:3).
    """

    dry_run = False

    def run(self, argv: Sequence[str], *, check: bool = True,
            timeout: float = 600.0, input_text: Optional[str] = None,
            ) -> CommandResult:
        logger.debug("run: %s", " ".join(argv))
        try:
            proc = subprocess.run(
                list(argv), capture_output=True, text=True,
                timeout=timeout, input=input_text)
            result = CommandResult(tuple(argv), proc.returncode,
                                   proc.stdout, proc.stderr)
        except FileNotFoundError as e:
            result = CommandResult(tuple(argv), 127, "", str(e))
        except subprocess.TimeoutExpired as e:
            result = CommandResult(tuple(argv), 124,
                                   (e.stdout or b"").decode() if isinstance(e.stdout, bytes) else (e.stdout or ""),
                                   f"timeout after {timeout}s")
        if check and not result.ok:
            raise CommandError(result)
        return result

    def retry(self, argv: Sequence[str], *, retries: int = 3,
              delay: float = 5.0, timeout: float = 600.0,
              until: Optional[Callable[[CommandResult], bool]] = None,
              ) -> CommandResult:
        """Retry loop matching the reference's test retry policy
        (llm-d-test.yaml:47-48: retries 3, delay 5) and convergence waits
        (kubernetes-single-node.yaml:286-292: retries 30, delay 10)."""
        last = None
        for attempt in range(retries):
            last = self.run(argv, check=False, timeout=timeout)
            if (until(last) if until else last.ok):
                return last
            if attempt < retries - 1:
                self.sleep(delay)
        return last

    def sleep(self, seconds: float) -> None:  # seam for tests
        time.sleep(seconds)


class DryRunRunner(CommandRunner):
    """Records commands instead of executing them (``deploy --dry-run``)."""

    dry_run = True

    def __init__(self):
        self.commands: list[tuple[str, ...]] = []

    def run(self, argv, *, check=True, timeout=600.0, input_text=None):
        self.commands.append(tuple(argv))
        logger.info("dry-run: %s", " ".join(argv))
        return CommandResult(tuple(argv), 0, "", "")

    def sleep(self, seconds: float) -> None:
        pass
