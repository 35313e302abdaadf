"""MLIP fine-tuning: energy and force matching, on one rank or over a
("data", "model") / ("data", "expert") mesh.

Port of ``pdb2reaction_tpu/mlip/train.py`` with its public names.
Adapting the potential to one enzyme active site is how force-field
users close the gap to DFT, so the fine-tune path is first-class:

- ``batched_loss`` / ``escn_batched_loss``: we * mean(((E - E_ref) /
  n)^2) + wf * mean(sum((F - F_ref * mask)^2) / (3 n)) over the batch,
  F = -dE/dx times the mask, n = max(sum(mask), 1); the forces come from
  a ``create_graph`` backward, so a step is reverse over reverse. The
  JAX package vmaps over the structures; the port loops over them.
- ``adam``: optax's Adam (``-lr * m_hat / (sqrt(v_hat + eps_root) +
  eps)``, the same defaults and state: ``AdamState(count, mu, nu)``,
  ``mu`` and ``nu`` one tensor a parameter leaf) with optax's
  ``init`` / ``update`` and ``apply_updates``.
- ``make_train_step`` / ``make_escn_train_step``: ``step(params,
  opt_state, batch) -> (params, opt_state, loss)``.
- ``make_sharded_train_step``: dp x tp, the batch over "data" and the
  ``param_shardings`` layout (the trailing dimension of every matrix
  over "model"); ``make_escn_sharded_train_step``: dp x ep, the MoLE
  banks' expert dimension over "expert" (``escn_param_shardings``).
  Each rank takes its contiguous block of the batch, which must divide
  the data axis (never padded: a repeated structure would weigh in the
  loss twice); the loss and the gradients are summed over the data axis
  in rank order and divided by its size; the optimizer state follows
  its parameter's block. ``parallel.unshard`` gathers the parameters
  back.

The routing (task, charge, spin) lives in the parameters and stays
fixed per run; the expert banks stay unmerged. A step computes through
the configuration it is given: on the CPU every configuration runs the
plain versions, as the JAX package's CPU does. On the card a kernel
configuration (an eSCN ``edge_kernel`` other than "xla", which runs K2
in every node FFN; the PaiNN ``mp_mode="pallas"``) is refused before
anything launches: the kernels' backwards are first order only
(``cuda_build.first_order``), as the JAX package's step fails on its
Pallas kernels. Train those models through their plain configuration.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, NamedTuple, Optional

import torch

from ..core.structure import PaddedSystem
from ..parallel.distributed import Shard
from ..parallel.mesh import Mesh, lay_out, map_tree
from .escn import ESCNConfig, escn_energy
from .model import ModelConfig, energy_fn


class TrainBatch(NamedTuple):
    numbers: torch.Tensor    # [B, Pa] int
    coords: torch.Tensor     # [B, Pa, 3] Angstrom
    atom_mask: torch.Tensor  # [B, Pa]
    energy: torch.Tensor     # [B] eV
    forces: torch.Tensor     # [B, Pa, 3] eV/Angstrom


def _system_of(numbers, coords, atom_mask) -> PaddedSystem:
    return PaddedSystem(numbers=numbers.long(), coords=coords,
                        atom_mask=atom_mask, free_mask=atom_mask,
                        masses=atom_mask)


def _loss(efn, params, batch: TrainBatch, w_energy, w_force):
    le, lf = [], []
    for numbers, coords, mask, e_ref, f_ref in zip(*batch):
        c = coords.detach().requires_grad_(True)
        e = efn(c, _system_of(numbers, c, mask), params)
        (g,) = torch.autograd.grad(e, c, create_graph=True)
        m = mask[:, None]
        f = -g * m
        n = torch.clamp(mask.sum(), min=1.0)
        le.append(((e - e_ref) / n) ** 2)
        lf.append(((f - f_ref * m) ** 2).sum() / (3.0 * n))
    return (w_energy * torch.stack(le).mean()
            + w_force * torch.stack(lf).mean())


def batched_loss(params, batch: TrainBatch, cfg: ModelConfig,
                 w_energy: float = 1.0, w_force: float = 10.0):
    """The PaiNN-class fit loss of one batch (a 0-d tensor)."""
    return _loss(lambda c, s, p: energy_fn(c, s, p, cfg), params, batch,
                 w_energy, w_force)


def escn_batched_loss(params, batch: TrainBatch, cfg: ESCNConfig,
                      w_energy: float = 1.0, w_force: float = 10.0):
    """The eSCN fit loss of one batch (a 0-d tensor)."""
    return _loss(lambda c, s, p: escn_energy(c, s, p, cfg), params, batch,
                 w_energy, w_force)


# ---------------------------------------------------------------------------
# parameter trees: leaves in a fixed order (dicts by sorted key, as
# jax.tree_util orders them; lists in order)
# ---------------------------------------------------------------------------

def _leaves(tree) -> List[Any]:
    out = []
    map_tree(tree, lambda _, x: out.append(x))
    return out


def _rebuild(tree, it):
    return map_tree(tree, lambda _, x: next(it))


def _local(x):
    return x.local if isinstance(x, Shard) else x


def _trainable(x) -> bool:
    return isinstance(_local(x), torch.Tensor) and \
        _local(x).is_floating_point()


def tree_leaves(params) -> List[torch.Tensor]:
    """The floating tensors of a parameter tree in the optimizer's order
    (a ``Shard`` gives this rank's block)."""
    return [_local(x) for x in _leaves(params) if _trainable(x)]


def _with_leaves(params, new):
    """``params`` with its trainable leaves replaced by ``new`` (a
    ``Shard`` keeps its layout)."""
    it = iter(new)
    leaves = [(x.with_local(next(it)) if isinstance(x, Shard) else next(it))
              if _trainable(x) else x for x in _leaves(params)]
    return _rebuild(params, iter(leaves))


# ---------------------------------------------------------------------------
# the optimizer: optax.adam
# ---------------------------------------------------------------------------

class AdamState(NamedTuple):
    count: torch.Tensor          # int32 steps taken
    mu: List[torch.Tensor]       # first moments, one a parameter leaf
    nu: List[torch.Tensor]       # second moments


@dataclasses.dataclass(frozen=True)
class Adam:
    """optax.adam(learning_rate, b1, b2, eps, eps_root): ``init(params)``,
    ``update(grads, state, params) -> (updates, state)``; ``grads`` and
    ``updates`` are lists in ``tree_leaves`` order."""

    learning_rate: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    eps_root: float = 0.0

    def init(self, params) -> AdamState:
        leaves = tree_leaves(params)
        return AdamState(torch.zeros((), dtype=torch.int32),
                         [torch.zeros_like(x) for x in leaves],
                         [torch.zeros_like(x) for x in leaves])

    def update(self, grads, state: AdamState, params=None):
        count = state.count + 1
        mu, nu, updates = [], [], []
        for g, m, v in zip(grads, state.mu, state.nu):
            m = (1 - self.b1) * g + self.b1 * m
            v = (1 - self.b2) * (g * g) + self.b2 * v
            c = count.to(m.dtype)
            m_hat = m / (1 - self.b1 ** c)
            v_hat = v / (1 - self.b2 ** c)
            updates.append(-self.learning_rate
                           * (m_hat / (torch.sqrt(v_hat + self.eps_root)
                                       + self.eps)))
            mu.append(m)
            nu.append(v)
        return updates, AdamState(count, mu, nu)


def adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, eps_root: float = 0.0) -> Adam:
    return Adam(learning_rate, b1, b2, eps, eps_root)


def apply_updates(params, updates):
    """``params`` plus ``updates`` leaf by leaf, in each leaf's dtype."""
    return _with_leaves(params, [(x + u).to(x.dtype) for x, u in
                                 zip(tree_leaves(params), updates)])


# ---------------------------------------------------------------------------
# the steps
# ---------------------------------------------------------------------------

def check_trainable(cfg, device) -> None:
    """Refuse a kernel configuration on the card before anything
    launches: the train step differentiates forces, and the kernels'
    backwards are first order only (``cuda_build.first_order``)."""
    if torch.device(device).type != "cuda":
        return
    if isinstance(cfg, ModelConfig) and cfg.mp_mode == "pallas":
        plain = 'mp_mode="dense" (or "gather")'
    elif isinstance(cfg, ESCNConfig) and cfg.edge_kernel != "xla":
        plain = 'edge_kernel="xla"'
    else:
        return
    raise RuntimeError(
        "a train step differentiates the forces, and the CUDA kernels of "
        "this configuration have no double backward (cuda_build."
        f"first_order): train on the card through {plain}, the plain "
        "configuration of the same weights")


def _device_of(params):
    return next(x.device for x in tree_leaves(params) if x.ndim > 0)


def _step(loss_fn, cfg, optimizer, params, opt_state, batch,
          data: Optional[Any] = None):
    check_trainable(cfg, _device_of(params))
    leaves = [x.detach().requires_grad_(True) for x in tree_leaves(params)]
    p = _with_leaves(params, leaves)
    if data is not None and data.size > 1:
        batch = _data_block(batch, data)
    loss = loss_fn(p, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(leaves, grads)]
    if data is not None and data.size > 1:
        *grads, loss = data.rank_sum([*grads, loss.detach()])
        grads = [g / data.size for g in grads]
        loss = loss / data.size
    updates, opt_state = optimizer.update(grads, opt_state, params)
    return apply_updates(params, updates), opt_state, loss.detach()


def make_train_step(cfg: ModelConfig, optimizer: Adam) -> Callable:
    def train_step(params, opt_state, batch: TrainBatch):
        return _step(lambda p, b: batched_loss(p, b, cfg), cfg, optimizer,
                     params, opt_state, batch)
    return train_step


def make_escn_train_step(cfg: ESCNConfig, optimizer: Adam) -> Callable:
    def train_step(params, opt_state, batch: TrainBatch):
        return _step(lambda p, b: escn_batched_loss(p, b, cfg), cfg,
                     optimizer, params, opt_state, batch)
    return train_step


def param_shardings(params, mesh: Mesh):
    """Tensor-parallel layout (a spec tree for ``parallel.lay_out``): the
    last (output-feature) dimension of every matrix over "model" where
    it divides; biases, embeddings' scalars and 0-d leaves replicate."""
    m = mesh.shape["model"]

    def spec_of(_, x):
        if isinstance(x, torch.Tensor) and x.ndim == 2 \
                and x.shape[-1] % m == 0 and x.shape[-1] >= m:
            return (None, "model")
        return ()
    return map_tree(params, spec_of)


def batch_shardings(mesh: Mesh) -> TrainBatch:
    """Every batch array over "data" (its leading dimension)."""
    return TrainBatch(*([("data",)] * len(TrainBatch._fields)))


def escn_param_shardings(params, cfg: ESCNConfig, mesh: Mesh):
    """Expert-parallel layout: every MoLE bank ({"w": [E, in, out], "b":
    [E, out]}) over "expert" along its expert dimension; everything else
    (embeddings, routing tables, norms) replicates."""
    E = cfg.num_experts
    ep = mesh.shape.get("expert", 1)

    def spec_of(path, x):
        key = path[-1] if path else None
        if isinstance(x, torch.Tensor) and E % ep == 0 and x.ndim \
                and x.shape[0] == E:
            if key == "w" and x.ndim == 3:
                return ("expert", None, None)
            if key == "b" and x.ndim == 2:
                return ("expert", None)
        return ()
    return map_tree(params, spec_of)


def _data_block(batch: TrainBatch, data) -> TrainBatch:
    B = batch.numbers.shape[0]
    if B % data.size:
        raise ValueError(f"a batch of {B} structures does not divide the "
                         f"data axis of {data.size} ranks: a training batch "
                         "is never padded (a repeated structure would "
                         "weigh twice in the loss)")
    k = B // data.size
    return TrainBatch(*(t[data.rank * k:(data.rank + 1) * k] for t in batch))


def _lay_out_state(opt_state: AdamState, laid) -> AdamState:
    """The optimizer state of the parameters ``laid`` holds, each moment
    cut to its parameter's block."""
    def cut(ts):
        out = []
        for t, x in zip(ts, [x for x in _leaves(laid) if _trainable(x)]):
            if isinstance(x, Shard):
                n = x.local.shape[x.dim]
                t = t.narrow(x.dim, x.group.rank * n, n).clone()
            out.append(t)
        return out
    return AdamState(opt_state.count, cut(opt_state.mu), cut(opt_state.nu))


def make_sharded_train_step(cfg: ModelConfig, optimizer: Adam, mesh: Mesh,
                            params, opt_state):
    """(step, params, opt_state): dp x tp over ``mesh``, the parameters
    and the optimizer state laid out by ``param_shardings``."""
    laid = lay_out(params, param_shardings(params, mesh), mesh)

    def train_step(params, opt_state, batch: TrainBatch):
        return _step(lambda p, b: batched_loss(p, b, cfg), cfg, optimizer,
                     params, opt_state, batch, data=mesh.data)
    return train_step, laid, _lay_out_state(opt_state, laid)


def make_escn_sharded_train_step(cfg: ESCNConfig, optimizer: Adam,
                                 mesh: Mesh, params, opt_state):
    """(step, params, opt_state): dp x ep over ``mesh``, the parameters
    and the optimizer state laid out by ``escn_param_shardings``."""
    laid = lay_out(params, escn_param_shardings(params, cfg, mesh), mesh)

    def train_step(params, opt_state, batch: TrainBatch):
        return _step(lambda p, b: escn_batched_loss(p, b, cfg), cfg,
                     optimizer, params, opt_state, batch, data=mesh.data)
    return train_step, laid, _lay_out_state(opt_state, laid)


def random_batch(gen: torch.Generator, cfg, batch: int, n_atoms: int,
                 n_pad: int, device="cpu") -> TrainBatch:
    """Synthetic training batch from ``gen`` (smoke runs): elements 1-8
    on the first ``n_atoms`` slots, coordinates uniform in [0, 4)
    Angstrom, normal energies and forces."""
    numbers = torch.randint(1, 9, (batch, n_pad), generator=gen)
    mask = (torch.arange(n_pad)[None, :] < n_atoms).float() \
        .expand(batch, n_pad)
    numbers = numbers * mask.long()
    coords = torch.rand(batch, n_pad, 3, generator=gen) * 4.0 \
        * mask[..., None]
    energy = torch.randn(batch, generator=gen)
    forces = torch.randn(batch, n_pad, 3, generator=gen) * mask[..., None]
    return TrainBatch(*(t.to(device) for t in (numbers, coords, mask,
                                               energy, forces)))
