"""Experience replay buffer for PPO rollouts — the port's copy of
dlrover_tpu/rl/replay_buffer.py (numpy only): it holds rollout batches
(tokens, logprobs, values, rewards, advantages) and serves shuffled
minibatches for the PPO epochs. `minibatches` draws its order from a
numpy `default_rng` exactly as the JAX package does, so one seed gives
both packages the same minibatches."""

import dataclasses
from typing import Iterator, List, Optional

import numpy as np


@dataclasses.dataclass
class Experience:
    tokens: np.ndarray        # [B, L]
    prompt_lens: np.ndarray   # [B]
    logprobs: np.ndarray      # [B, L-1] behavior-policy logprobs
    values: np.ndarray        # [B, L-1]
    advantages: np.ndarray    # [B, L-1]
    returns: np.ndarray       # [B, L-1]
    mask: np.ndarray          # [B, L-1] 1 on generated positions

    def __len__(self) -> int:
        return self.tokens.shape[0]


class ReplayBuffer:
    def __init__(self, capacity: int = 0):
        self.capacity = capacity
        self._items: List[Experience] = []

    def add(self, exp: Experience):
        self._items.append(exp)
        if self.capacity and self._total() > self.capacity:
            self._items.pop(0)

    def _total(self) -> int:
        return sum(len(e) for e in self._items)

    def __len__(self) -> int:
        return self._total()

    def clear(self):
        self._items.clear()

    def _stacked(self) -> Experience:
        return Experience(
            **{
                fld.name: np.concatenate(
                    [getattr(e, fld.name) for e in self._items]
                )
                for fld in dataclasses.fields(Experience)
            }
        )

    def minibatches(
        self,
        batch_size: int,
        rng: Optional[np.random.Generator] = None,
        epochs: int = 1,
    ) -> Iterator[Experience]:
        """Shuffled minibatches over all stored experience: each epoch
        one `rng.permutation`, cut into whole batches (a tail shorter
        than the batch is dropped); a buffer smaller than the batch
        gives one batch of all of it."""
        if not self._items:
            return
        all_exp = self._stacked()
        n = len(all_exp)
        bs = min(batch_size, n)
        rng = rng or np.random.default_rng(0)
        for _ in range(epochs):
            order = rng.permutation(n)
            for i in range(0, n - bs + 1, bs):
                idx = order[i : i + bs]
                yield Experience(
                    **{
                        fld.name: getattr(all_exp, fld.name)[idx]
                        for fld in dataclasses.fields(Experience)
                    }
                )
