"""The device a run measures: the CUDA card, or the CPU for the harness's
own tests.  A measurement path that finds no card fails; only the tests
ask for the CPU, and a CPU run's numbers are never printed as a result.

A cell whose mix names a mesh runs one process per card: rank r measures
``Cuda(chips, r)``, card r, and joins the NCCL group (``backend``); on the
CPU, the tests' ranks join a gloo group."""

from __future__ import annotations

import subprocess

import torch


class NoCard(RuntimeError):
    pass


class Cuda:
    kind = "cuda"
    platform = "gpu"
    backend = "nccl"

    @staticmethod
    def check(chips: int):
        """Raises NoCard unless ``chips`` CUDA devices are visible; creates
        no context."""
        if not torch.cuda.is_available():
            raise NoCard("no CUDA device: this benchmark measures the card "
                         "and does not fall back to the CPU")
        if torch.cuda.device_count() < chips:
            raise NoCard(f"the cell needs {chips} CUDA devices, "
                         f"{torch.cuda.device_count()} are visible")

    def __init__(self, chips: int, index: int = 0):
        self.check(chips)
        self.count = chips
        self.index = index
        self.device = torch.device("cuda", index)
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
        return torch.cuda.get_device_name(self.index)

    def card_line(self) -> str:
        """nvidia-smi's name and power limit of the card."""
        try:
            return subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader", "-i", str(self.index)],
                capture_output=True, text=True, timeout=30,
                check=True).stdout.strip()
        except (OSError, subprocess.SubprocessError) as e:
            return f"{self.name()}, power limit unread ({e})"


class Cpu:
    """The CPU, for the harness's tests only."""
    kind = "cpu"
    platform = "cpu"
    backend = "gloo"
    device = torch.device("cpu")

    def __init__(self, chips: int = 1, index: int = 0):
        self.count = chips
        self.index = index

    @staticmethod
    def check(chips: int):
        pass

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
