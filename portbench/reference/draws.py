"""The program's random draws, worked out again from the seeds the
harness hands it.

The port draws with ``torch`` generators on the card, in a fixed order
(commit 3ec051a): a training pass draws ``torch.randperm(n)`` of its rows,
then each step the standard-normal noise of each encoder layer,
``[k, B, latent_i]``, layer by layer (``training/epoch.py``,
``models/iwae.encode``, ``ops/distributions.normal_sample``); a k-sample
estimate draws the same per chunk of samples (``evaluation/metrics
.streaming_log_px``). Calling the same generator functions with the same
seed, shapes and order gives the same numbers, so the reference sees the
very draws the program saw without reading any of them from it.
"""

from __future__ import annotations

from typing import Callable, Iterator, List, Sequence, Tuple

import torch


def encoder_noise(gen: torch.Generator, k: int, rows: int,
                  latents: Sequence[int], device) -> List[torch.Tensor]:
    return [torch.randn((k, rows, d), generator=gen, device=device)
            for d in latents]


def train_passes(seed: int, x: torch.Tensor, passes: int, batch: int, k: int,
                 latents: Sequence[int]
                 ) -> Iterator[Tuple[torch.Tensor, List[torch.Tensor]]]:
    """The batches and noise of `passes` shuffled passes over the rows `x`,
    all drawn from one generator seeded `seed`: ``(batch, noise)`` per
    step, drawn as the steps ask for them, so that memory holds one
    step's."""
    gen = torch.Generator(device=x.device).manual_seed(seed)
    for _ in range(passes):
        perm = torch.randperm(x.shape[0], generator=gen, device=x.device)
        for j in range(x.shape[0] // batch):
            rows = x.index_select(0, perm[j * batch:(j + 1) * batch])
            yield rows, encoder_noise(gen, k, batch, latents, x.device)


def chunk_draws(seed: int, n_chunks: int, chunk: int, rows: int,
                latents: Sequence[int], device
                ) -> List[Callable[[], List[torch.Tensor]]]:
    """Callables giving, in order, the noise of `n_chunks` chunks of
    `chunk` samples drawn from one generator seeded `seed`. Call them in
    order: each draws from the shared generator."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return [lambda: encoder_noise(gen, chunk, rows, latents, device)
            for _ in range(n_chunks)]
