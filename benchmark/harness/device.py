"""The device a run measures: the CUDA card, or the CPU for the harness's
own tests.  A measurement path that finds no card fails; only the tests
ask for the CPU, and a CPU run's numbers are never printed as a result."""

from __future__ import annotations

import subprocess

import torch


class NoCard(RuntimeError):
    pass


class Cuda:
    kind = "cuda"
    platform = "gpu"

    def __init__(self, chips: int):
        if not torch.cuda.is_available():
            raise NoCard("no CUDA device: this benchmark measures the card "
                         "and does not fall back to the CPU")
        if torch.cuda.device_count() < chips:
            raise NoCard(f"the cell needs {chips} CUDA devices, "
                         f"{torch.cuda.device_count()} are visible")
        self.count = chips
        self.device = torch.device("cuda", 0)
        torch.cuda.set_device(self.device)
        torch.zeros(1, device=self.device)     # the context, now
        torch.cuda.synchronize()

    def sync(self):
        torch.cuda.synchronize()

    def reset_peak(self):
        torch.cuda.reset_peak_memory_stats()

    def peak_bytes(self) -> int:
        return torch.cuda.max_memory_allocated()

    def name(self) -> str:
        return torch.cuda.get_device_name(0)

    def card_line(self) -> str:
        """nvidia-smi's name and power limit of the card."""
        try:
            return subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader", "-i", "0"],
                capture_output=True, text=True, timeout=30,
                check=True).stdout.strip()
        except (OSError, subprocess.SubprocessError) as e:
            return f"{self.name()}, power limit unread ({e})"


class Cpu:
    """The CPU, for the harness's tests only."""
    kind = "cpu"
    platform = "cpu"
    count = 1
    device = torch.device("cpu")

    def sync(self):
        pass

    def reset_peak(self):
        pass

    def peak_bytes(self):
        return None

    def name(self) -> str:
        return "cpu"

    def card_line(self) -> str:
        return "cpu"
