"""On-device semi-hard triplet mining. Port of
face_recognition_models_tpu/ops/mining.py.

The reference mines on the host with a Python double loop after copying the
distance matrix there (FaceNet/main.py:96-128: for each anchor-positive
pair, a RANDOM negative with d_ap < d_an < d_ap + margin, else the HARDEST
negative beyond d_ap). Here the selection is a masked argmax over a
[B, B, B] mask on the device, with every shape static (no `nonzero`, no
read back to the host), so a step that mines can be captured in a CUDA
graph. The random pick is a Gumbel argmax; its noise comes from a
torch.Generator (`gumbel`), and `semi_hard_negatives_from_noise` takes the
noise itself, so a test can hand it the JAX package's draws.

Distances follow the reference: mining uses SQUARED distances of the
normalised embeddings (2 - 2 cos, main.py:82-89); the loss uses EUCLIDEAN
distances (F.pairwise_distance, utils/criterions.py:10-14), with 1e-16
under the root. The pairwise product is IEEE fp32: callers on the card keep
TF32 off (`torch.backends.cuda.matmul.allow_tf32 = False`), the analogue
of the JAX package's Precision.HIGHEST.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


def pairwise_sq_distances(embeddings: torch.Tensor) -> torch.Tensor:
    """Squared pairwise distances of L2-normalised embeddings:
    ||u - v||^2 = 2 - 2 u.v, clamped at 0 (FaceNet/main.py:82-89)."""
    emb = embeddings.to(torch.float32)
    return torch.clamp_min(2.0 - 2.0 * (emb @ emb.T), 0.0)


class MiningResult(NamedTuple):
    negatives: torch.Tensor   # [B, B] chosen negative index per (a, p) pair
    valid: torch.Tensor       # [B, B] bool: (a, p) is a usable triplet


def gumbel(shape, rng: Optional[torch.Generator], device) -> torch.Tensor:
    """Standard Gumbel noise from the generator `rng`, as jax.random.gumbel
    draws it: -log(-log(u)), u uniform in [tiny, 1)."""
    u = torch.rand(shape, generator=rng, device=device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))


def semi_hard_negatives_from_noise(dist_sq: torch.Tensor,
                                   labels: torch.Tensor, margin: float,
                                   noise: torch.Tensor) -> MiningResult:
    """For every anchor-positive pair (i, j), choose a negative k, the
    random choice among candidates being the argmax of `noise` [B, B, B].

    Selection rule (reference main.py:104-124):
      1. candidates: labels[k] != labels[i] and
         d_ap < d_ak < d_ap + margin -> the candidate of largest noise;
      2. fallback: negatives with d_ak > d_ap -> the HARDEST (smallest
         d_ak);
      3. neither -> the pair is invalid.
    Ties go to the first index, as jnp.argmax / argmin break them.
    """
    b = dist_sq.shape[0]
    same = labels[:, None] == labels[None, :]             # [B, B]
    eye = torch.eye(b, dtype=torch.bool, device=dist_sq.device)
    pos_pair = same & ~eye                                # anchor-positive
    negm = (~same)[:, None, :]                            # [B, 1, B]

    d_ap = dist_sq[:, :, None]                            # [B, B, 1]
    d_an = dist_sq[:, None, :]                            # [B, 1, B]
    harder = negm & (d_an > d_ap)                         # [B, B, B]
    semi = harder & (d_an < d_ap + margin)

    inf = torch.tensor(float("inf"), device=dist_sq.device)
    random_pick = torch.argmax(torch.where(semi, noise, -inf), dim=-1)
    hard_pick = torch.argmin(
        torch.where(harder, d_an.expand_as(harder), inf), dim=-1)

    has_semi = semi.any(-1)
    negatives = torch.where(has_semi, random_pick, hard_pick)
    valid = pos_pair & (has_semi | harder.any(-1))
    return MiningResult(negatives=negatives, valid=valid)


def semi_hard_negatives(dist_sq: torch.Tensor, labels: torch.Tensor,
                        margin: float,
                        rng: Optional[torch.Generator]) -> MiningResult:
    """semi_hard_negatives_from_noise with [B, B, B] Gumbel noise drawn
    from `rng` (the reference's np.random.choice, main.py:117)."""
    b = dist_sq.shape[0]
    return semi_hard_negatives_from_noise(
        dist_sq, labels, margin, gumbel((b, b, b), rng, dist_sq.device))


def mined_triplet_loss(embeddings: torch.Tensor, labels: torch.Tensor,
                       margin: float, rng: Optional[torch.Generator]):
    """(loss, mining result) of semi_hard_triplet_loss."""
    emb = embeddings.to(torch.float32)
    dist_sq = pairwise_sq_distances(emb)
    mined = semi_hard_negatives(dist_sq.detach(), labels, margin, rng)

    d = torch.sqrt(dist_sq + 1e-16)                       # euclidean
    b = d.shape[0]
    # d[a, negatives[a, p]] as a masked sum, not a gather: the gather's
    # backward adds repeated picks with float atomics on the card, in an
    # order that moves with timing
    pick = mined.negatives[..., None] == torch.arange(b, device=d.device)
    d_an = torch.where(pick, d[:, None, :], 0.0).sum(-1)  # [B, B]
    per_pair = torch.clamp_min(d - d_an + margin, 0.0)

    v = mined.valid.to(torch.float32)
    count = torch.clamp_min(v.sum(), 1.0)
    return (per_pair * v).sum() / count, mined


def semi_hard_triplet_loss(embeddings: torch.Tensor, labels: torch.Tensor,
                           margin: float = 0.2,
                           rng: Optional[torch.Generator] = None
                           ) -> torch.Tensor:
    """Batch-all semi-hard triplet loss, on the device.

    mean over the mined (a, p, n) of relu(||a-p|| - ||a-n|| + margin)
    (TripletLoss, FaceNet/utils/criterions.py:10-14: euclidean distances).
    0 when no valid triplet exists (the reference returns None and skips
    the step; a zero loss gives zero gradients, the same effect, with no
    host branch). Without `rng` the noise comes from the global generator
    of the embeddings' device."""
    return mined_triplet_loss(embeddings, labels, margin, rng)[0]
