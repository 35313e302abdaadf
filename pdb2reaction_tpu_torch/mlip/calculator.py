"""Calculator: the unit-converting, freeze-aware facade over a potential.

Same contract as ``pdb2reaction_tpu/mlip/calculator.py``:

- ``get_energy(coords_bohr)``  -> {"energy": Hartree}
- ``get_forces(coords_bohr)``  -> {"energy", "forces"}: forces flat 3N in
  Hartree/Bohr, frozen atoms zeroed
- ``get_forces_batch(coords [B, 3N])`` -> {"energy" [B], "forces" [B, 3N]}
- ``get_hessian(coords_bohr)`` -> {..., "hessian"} [3N, 3N] Hartree/Bohr^2
  (the free block alone with ``return_partial_hessian``), frozen rows and
  columns zeroed

The potential is ``energy_fn(coords_ang [P, 3], system, params) -> eV``
over a padded system on the calculator's device; forces are autograd
gradients. The device defaults to the card, as the JAX calculator runs
on its accelerator: without one it raises, and the CPU runs only when
the caller passes ``device="cpu"``. ``force_calls`` counts every force
evaluation, batched images and finite-difference displacements included;
the closures the engines call count their own evaluations.

Second derivatives (the analytic Hessian, HVPs) differentiate
``energy_fn_hessian`` when one is given, else ``energy_fn``. The CUDA
kernels' autograd functions have no double backward (their backwards
are ``cuda_build.first_order``: one taken with ``create_graph`` raises),
and a calculator whose force path runs them is given an all-plain
variant here (``mlip/uma.py``), as the JAX factory gives its Hessian
closure the XLA variant.

Batched work runs in chunks, as the JAX calculator's ``_stream_chunks``
and ``lax.map(batch_size=...)`` do: image batches (``get_forces_batch``,
``au_energy_force_batch_fn``) in chunks of ``batch_chunk`` images (else
``PDB2R_TPU_BATCH_CHUNK``, else 1), the analytic Hessian's free-DOF
tangents in chunks of ``PDB2R_TPU_HVP_CHUNK`` (default
``HVP_CHUNK_DEFAULT``) and the FD Hessian's displacements in chunks of
``PDB2R_TPU_FD_CHUNK`` (default ``FD_CHUNK_DEFAULT``). A chunk of
tangents is one batched backward on the point's graph
(``torch.autograd.grad(..., is_grads_batched=True)``: vmap over the
double backward of the Hessian closure). A chunk of images or
displacements is one call of ``energy_fn_images`` where the calculator
has one (the eSCN factory's: the images stacked along the atom axis,
each kernel launched once a layer for the chunk, split where a launch
would pass 32-bit offsets), else the images one after another. A chunk
that fails raises; nothing drops to smaller chunks.

``mesh`` (``parallel.make_mesh``) with a data axis of n > 1 ranks and no
model axis splits the batched work over the ranks, as the JAX
calculator's ``shard_map`` over "data" does: image batches, the analytic
Hessian's free-DOF tangents and the FD Hessian's displacements. The
chunk is rounded up to a multiple of n; each rank evaluates one
contiguous block of the batch, padded to a multiple of n by repeating
its last row, in chunks of (chunk / n) items, and the blocks are
all-gathered in rank order, so every rank holds the same bits; every
rank counts all B force calls, as the JAX calculator does. A batch's
last chunk is shorter where the batch ends (the JAX package pads it to
its compiled shape; eager PyTorch has none to fill). Everything
else (single force calls, ``au_hvp_fn``) runs whole on every rank. Under
atom-axis sharding (``spatial > 1``) every rank of the model group takes
part in every evaluation, Hessians and HVPs included, through the
sharded closures, and the data axis is off. So it is under tensor
parallelism (``shard_params_model``: a model axis with ``spatial`` 1,
the parameters' feature columns laid over it): every rank of the model
group takes part in every evaluation through the laid-out parameters.
Their collectives have no batching rule, so there a chunk's tangents
and images run one after another, each with the whole model group.
"""

from __future__ import annotations

import os
import weakref
from typing import Any, Callable, Dict

import numpy as np
import torch

from ..constants import BOHR2ANG, EV2AU, F_EVAA_2_AU, H_EVAA_2_AU
from ..core.structure import Structure, pad_to
from ..parallel.mesh import data_size, replicate, shard_batch
from ..runtime.device_loop import per_cycle

_SENTINEL = object()

# chunk defaults: images and FD displacements as in the JAX package (1
# and 64); HVP tangents 2, not JAX's 64: the largest power of two whose
# batched backward fits the card with 20% to spare wherever the card's
# smoke run takes it, three stage-4 CLI processes on one card included
# (escn-md at P = 320 peaks at 19.8 GiB with 2 tangents, 27.2 with 4,
# 41.9 with 8; ROADMAP.md, "Behaviours of the reference")
BATCH_CHUNK_DEFAULT = 1
HVP_CHUNK_DEFAULT = 2
FD_CHUNK_DEFAULT = 64


def chunk_setting(given, env: str, default: int) -> int:
    """``given``, else the environment variable ``env``, else
    ``default``; a positive integer."""
    c = int(given) if given else int(os.environ.get(env, str(default)))
    if c < 1:
        raise ValueError(f"{env}={c}: a chunk holds at least one item")
    return c


def resolve_device(device) -> torch.device:
    """The requested device; CUDA without a card raises (no fallback).
    On CUDA both TF32 switches are turned off, so the plain f32 paths
    around the kernels (edge MLP, Wigner recursion) stay full f32."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' was requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run the plain CPU path")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


class Calculator:
    """Freeze-aware, unit-converting calculator over a padded potential."""

    def __init__(
        self,
        structure: Structure,
        energy_fn: Callable,
        *,
        params: Any = None,
        freeze_atoms=None,
        hessian_calc_mode: str = "Analytical",
        return_partial_hessian: bool = False,
        hessian_double: bool = True,
        fd_step: float = 1.0e-3,
        pad_multiple: int = 8,
        device="cuda",
        dtype: torch.dtype = torch.float64,
        weights_source: str = "analytic",
        energy_fn_hessian: Callable = None,
        mesh=None,
        batch_chunk: int = None,
        energy_fn_images: Callable = None,
    ):
        if freeze_atoms is not None:
            structure = structure.copy()
            structure.freeze = sorted(set(int(i) for i in freeze_atoms))
        self.structure = structure
        self.device = resolve_device(device)
        self.system = pad_to(structure, multiple=pad_multiple,
                             device=self.device)
        self.n_atoms = structure.n_atoms
        self.n_pad = self.system.n_pad
        self.energy_fn = energy_fn
        self.energy_fn_hessian = energy_fn_hessian
        # (coords [B, P, 3], system, params) -> eV [B] in one pass, with
        # ``max_images(P)``; None: a chunk's images one after another
        self.energy_fn_images = energy_fn_images
        self.batch_chunk = batch_chunk
        self.params = params
        if hessian_calc_mode == "auto":
            hessian_calc_mode = "Analytical"
        self.hessian_calc_mode = hessian_calc_mode or "FiniteDifference"
        self.return_partial_hessian = return_partial_hessian
        self.hessian_double = hessian_double
        self.fd_step = float(fd_step)
        # atom-axis shards of the potential (set by make_uma_calculator)
        self.spatial = 1
        self.mesh = mesh
        # dtype of the coordinates handed to the potential (the model may
        # compute in its own dtype); Hartree/Bohr results are float64
        self.dtype = dtype
        self.weights_source = str(weights_source)
        self.force_calls = 0
        self.energy_calls = 0

    # the GSM loop that ``gs_kw`` loop="auto" resolves to
    # (``workflows/path_opt.py``): the device loop, as the JAX package's
    # base calculator; eSCN calculators take the host loop (``mlip/uma.py``)
    gsm_loop_default = "device"

    # -- helpers ------------------------------------------------------------
    def _to_pad_ang(self, coords_bohr) -> torch.Tensor:
        c = np.asarray(coords_bohr, dtype=np.float64).reshape(-1, 3) * BOHR2ANG
        assert c.shape[0] == self.n_atoms, (c.shape, self.n_atoms)
        out = np.zeros((self.n_pad, 3), dtype=np.float64)
        out[: self.n_atoms] = c
        return torch.as_tensor(out, dtype=self.dtype, device=self.device)

    @property
    def free_dof_mask(self) -> np.ndarray:
        """[3N] bool over real atoms: movable DOFs."""
        m = self.system.free_mask[: self.n_atoms].cpu().numpy() > 0
        return np.repeat(m, 3)

    def pack(self, params=_SENTINEL):
        """(system, params) for the packed-signature closures."""
        return (self.system,
                self.params if params is _SENTINEL else params)

    def _over_data(self, items: torch.Tensor, run, chunk: int) \
            -> torch.Tensor:
        """``run(rows)`` [c, ...] over ``items`` [B, ...] in chunks of
        ``chunk`` rows, stacked. Over a data axis of n ranks the chunk is
        rounded up to a multiple of n, each rank takes its contiguous
        block of the batch (padded to a multiple of n by repeating its
        last row) in chunks of chunk / n rows, and every rank's blocks
        are gathered in rank order (the same bits on every rank). The
        last chunk is shorter where the batch ends: unlike the JAX
        package, which pads it to one compiled program's shape, no row
        is evaluated twice beyond the data axis's padding."""
        n = data_size(self.mesh)
        c = -(-chunk // n)
        block = shard_batch(items, self.mesh)
        out = torch.cat([run(block[i:i + c])
                         for i in range(0, block.shape[0], c)])
        return replicate(out, self.mesh, items.shape[0])

    def _one_by_one(self) -> bool:
        """True where a chunk's tangents and images run one after another:
        atom-axis sharded closures (marked ``collective``) and
        tensor-parallel parameters, whose collectives have no batching
        rule and take the whole model group for each item."""
        return getattr(self, "_tensor_parallel", False) or any(
            getattr(f, "collective", False)
            for f in (self.energy_fn, self.energy_fn_hessian))

    def shard_params_model(self):
        """Reshard ``self.params`` for tensor-parallel inference over the
        mesh's "model" axis (``parallel.shard_params_model``: feature
        columns laid over the ranks, the same results) and drop the
        cached closures, so the batched and Hessian closures run on the
        laid-out parameters too. No-op without a mesh. Refused under
        atom-axis sharding (``spatial > 1``), whose model axis already
        carries atom rows."""
        if self.mesh is None:
            return self
        if self.spatial > 1:
            raise ValueError(
                f"shard_params_model: this calculator shards the atom axis "
                f"over the mesh's model axis (spatial={self.spatial}); the "
                "tensor-parallel layout lays feature columns over that "
                "axis, so it needs spatial=1")
        from ..parallel.mesh import shard_params_model
        self.params = shard_params_model(self.params, self.mesh)
        self._tensor_parallel = self.mesh.shape.get("model", 1) > 1
        self._batch_closure = None
        self._hvp_closure = None
        return self

    def _eforce_ang(self, coords_ang: torch.Tensor):
        """(E eV, F eV/Angstrom [P, 3] with frozen and padding rows zero)."""
        c = coords_ang.detach().requires_grad_(True)
        e = self.energy_fn(c, self.system, self.params)
        (g,) = torch.autograd.grad(e, c)
        f = -g * self.system.free_mask[:, None].to(g.dtype)
        return e.detach(), f

    def _images_fn(self):
        """``energy_fn_images`` where a chunk may be stacked, else None."""
        return None if self._one_by_one() else self.energy_fn_images

    def _eforce_images(self, coords_ang: torch.Tensor):
        """(E eV [B], F eV/Angstrom [B, P, 3], frozen and padding rows
        zero) of a chunk of images [B, P, 3]: through
        ``energy_fn_images`` in passes of at most its ``max_images(P)``
        images, else (and for one image) one image after another."""
        fn = self._images_fn()
        if fn is None or coords_ang.shape[0] == 1:
            es, fs = zip(*(self._eforce_ang(x) for x in coords_ang))
            return torch.stack(es), torch.stack(fs)
        lim = fn.max_images(self.n_pad)
        es, fs = [], []
        for lo in range(0, coords_ang.shape[0], lim):
            c = coords_ang[lo:lo + lim].detach().requires_grad_(True)
            e = fn(c, self.system, self.params)
            (g,) = torch.autograd.grad(e.sum(), c)
            es.append(e.detach())
            fs.append(-g * self.system.free_mask[:, None].to(g.dtype))
        return torch.cat(es), torch.cat(fs)

    # -- public API (Bohr/Hartree) -------------------------------------------
    def get_energy(self, coords_bohr) -> Dict[str, Any]:
        with torch.no_grad():
            e_ev = self.energy_fn(self._to_pad_ang(coords_bohr), self.system,
                                  self.params)
        self.energy_calls += 1
        return {"energy": float(e_ev) * EV2AU}

    def get_forces(self, coords_bohr) -> Dict[str, Any]:
        e_ev, f = self._eforce_ang(self._to_pad_ang(coords_bohr))
        self.force_calls += 1
        f = f.double().cpu().numpy()[: self.n_atoms] * F_EVAA_2_AU
        return {"energy": float(e_ev) * EV2AU, "forces": f.reshape(-1)}

    def get_forces_batch(self, coords_bohr_batch) -> Dict[str, Any]:
        """B images through ``au_energy_force_batch_fn``: [B, 3N] or
        [B, N, 3] Bohr."""
        cb = np.asarray(coords_bohr_batch, dtype=np.float64)
        B = cb.shape[0]
        x = np.zeros((B, self.n_pad, 3), dtype=np.float64)
        x[:, : self.n_atoms] = cb.reshape(B, -1, 3)
        e, f = self.au_energy_force_batch_fn()(
            torch.as_tensor(x, device=self.device))
        f = f[:, : self.n_atoms].reshape(B, -1)
        return {"energy": e.cpu().numpy(), "forces": f.cpu().numpy()}

    def get_hessian(self, coords_bohr) -> Dict[str, Any]:
        mode = self.hessian_calc_mode
        if not mode or mode not in ("Analytical", "FiniteDifference"):
            mode = "FiniteDifference"
        if mode == "Analytical":
            H_au = self._analytic_hessian(coords_bohr)
        else:
            H_au = self._fd_hessian(coords_bohr)
        res = self.get_forces(coords_bohr)
        free = self.free_dof_mask
        if self.return_partial_hessian:
            H_au = H_au[np.ix_(free, free)]
        else:
            Hm = np.zeros_like(H_au)
            Hm[np.ix_(free, free)] = H_au[np.ix_(free, free)]
            H_au = Hm
        dtype = np.float64 if self.hessian_double else np.float32
        res["hessian"] = H_au.astype(dtype)
        return res

    # -- second derivatives ------------------------------------------------------
    # Reverse over reverse: one forward and one create_graph backward give
    # the gradient g(c) with its graph, and each H v is one more backward,
    # the VJP of g with v (H is symmetric). Chosen over forward over
    # reverse (torch.func.jvp of torch.func.grad) because every op of the
    # plain paths has a double backward in autograd, while forward mode
    # needs functorch-compatible code (the models' constant caches and the
    # detached neighbour search), and because one graph then serves every
    # tangent at one point: a Hessian builds it once, a Lanczos run once
    # per point.
    def _grad_graph(self, coords_ang, system, params):
        """(c, g = dE/dc with its graph) at coords_ang [P, 3] (Angstrom)
        through the Hessian closure."""
        fn = self.energy_fn_hessian or self.energy_fn
        c = coords_ang.detach().requires_grad_(True)
        with torch.enable_grad():
            e = fn(c, system, params)
            (g,) = torch.autograd.grad(e, c, create_graph=True)
        return c, g

    @staticmethod
    def _vjp(c, g, v, batched=False):
        """H v [P, 3] (eV/Angstrom^2 per unit tangent) on a graph of
        ``_grad_graph``; zero when g does not depend on c. ``batched``:
        v [C, P, 3] holds C tangents, taken in one backward (vmap over
        the double backward) -> [C, P, 3]."""
        if not g.requires_grad:
            return torch.zeros_like(v if batched else c)
        (hv,) = torch.autograd.grad(g, c, grad_outputs=v.to(g.dtype),
                                    retain_graph=True, allow_unused=True,
                                    is_grads_batched=batched)
        if hv is None:
            return torch.zeros_like(v if batched else c)
        return hv

    def _analytic_hessian(self, coords_bohr) -> np.ndarray:
        """H e_k for the unit tangent of every free DOF on one graph, the
        rows gathered on the device and copied to the host once. The free
        block, symmetrised as 0.5 (H + H^T), needs no other row: frozen
        rows and columns are zero. A 25-atom active region of 300 atoms
        takes 75 tangents instead of 900. The tangents go in chunks of
        ``PDB2R_TPU_HVP_CHUNK``, each one batched backward. Over a data
        axis each rank builds the graph once and computes its block of
        the tangents."""
        n3 = self.n_atoms * 3
        dof_ids = np.nonzero(self.free_dof_mask)[0]
        H = np.zeros((n3, n3), dtype=np.float64)
        if not dof_ids.size:
            return H
        c, g = self._grad_graph(self._to_pad_ang(coords_bohr), self.system,
                                self.params)
        one = self._one_by_one()

        def rows(ks):
            V = torch.zeros((ks.shape[0], c.numel()), dtype=c.dtype,
                            device=c.device)
            V[torch.arange(ks.shape[0]), ks.to(c.device)] = 1.0
            V = V.view(-1, *c.shape)
            if one or ks.shape[0] == 1:
                hv = torch.stack([self._vjp(c, g, v) for v in V])
            else:
                hv = self._vjp(c, g, V, batched=True)
            return hv.reshape(ks.shape[0], -1)[:, :n3]

        R = self._over_data(torch.as_tensor(dof_ids), rows, chunk_setting(
            None, "PDB2R_TPU_HVP_CHUNK", HVP_CHUNK_DEFAULT))
        R = R.double().cpu().numpy()[:, dof_ids]
        H[np.ix_(dof_ids, dof_ids)] = 0.5 * (R + R.T)
        return H * H_EVAA_2_AU

    def _fd_hessian(self, coords_bohr) -> np.ndarray:
        """Central differences over the free DOFs (eps = ``fd_step``
        Angstrom) through the force path, 2 n_free force calls in chunks
        of ``PDB2R_TPU_FD_CHUNK`` displacements (split over a data axis),
        each chunk one batched force call (``_eforce_images``), the forces
        gathered on the device and copied to the host once."""
        c0 = self._to_pad_ang(coords_bohr)
        eps = self.fd_step
        free = self.free_dof_mask
        n3 = self.n_atoms * 3
        dof_ids = np.nonzero(free)[0]
        B = dof_ids.size
        dofs = torch.as_tensor(dof_ids, device=c0.device)

        def forces(js):
            js = js.to(c0.device)
            c = c0.reshape(1, -1).repeat(js.shape[0], 1)
            step = torch.full(js.shape, eps, dtype=c.dtype, device=c.device)
            c[torch.arange(js.shape[0]), dofs[js % B]] += torch.where(
                js < B, step, -step)
            _, f = self._eforce_images(c.view(-1, *c0.shape))
            return f.reshape(js.shape[0], -1)[:, :n3]

        f = (self._over_data(torch.arange(2 * B), forces, chunk_setting(
            None, "PDB2R_TPU_FD_CHUNK", FD_CHUNK_DEFAULT)) if B
             else torch.zeros(0, n3))
        self.force_calls += 2 * B
        f = f.double().cpu().numpy()
        fp, fm = f[:B], f[B:]
        H = np.zeros((n3, n3), dtype=np.float64)
        # column k = -(F(x + e_k) - F(x - e_k)) / (2 eps)   [eV/Ang^2]
        H[:, dof_ids] = (-(fp - fm) / (2.0 * eps)).T
        H = 0.5 * (H + H.T)
        return H * H_EVAA_2_AU

    # -- padded Bohr closures used by engines -------------------------------------
    def _au_eforce(self, coords_bohr_pad):
        """(E Hartree 0-d float64 tensor, F Hartree/Bohr [P, 3] float64)."""
        c = coords_bohr_pad.to(self.dtype) * BOHR2ANG
        e_ev, f = self._eforce_ang(c)
        return e_ev.double() * EV2AU, f.double() * F_EVAA_2_AU

    def au_energy_force_fn(self):
        """coords_bohr_pad [P, 3] tensor -> (E Hartree float, F Hartree/Bohr
        [P, 3] float64 tensor, frozen and padding rows zero). Every call
        counts as a force call."""
        def fn(coords_bohr_pad):
            e, f = self._au_eforce(coords_bohr_pad)
            self.force_calls += 1
            return float(e), f
        return fn

    def au_energy_force_batch_fn(self):
        """[B, P, 3] Bohr tensor -> (E [B] Hartree, F [B, P, 3] Hartree/Bohr),
        float64 tensors on the device, frozen and padding rows zero. The
        images run in chunks of ``batch_chunk`` (``_eforce_images``: one
        stacked pass a chunk where the calculator has
        ``energy_fn_images``), with no host sync between them, over a
        data axis each rank its block; each image counts as a force call
        on every rank, through ``device_loop.per_cycle``: inside a
        captured device loop once per cycle that took effect, never at
        the warm-up or capture. ``collective`` marks a closure whose
        ranks exchange data through gloo (atom-axis sharding,
        tensor-parallel parameters, a data axis), which a CUDA graph
        cannot capture. One closure per (calculator, params)."""
        cached = getattr(self, "_batch_closure", None)
        if cached is not None and cached[0] is self.params:
            return cached[1]
        chunk = chunk_setting(self.batch_chunk, "PDB2R_TPU_BATCH_CHUNK",
                              BATCH_CHUNK_DEFAULT)

        def run(coords):
            if coords.shape[0] == 1 or self._images_fn() is None:
                e, f = zip(*(self._au_eforce(x) for x in coords))
                e, f = torch.stack(e), torch.stack(f)
            else:
                e, f = self._eforce_images(coords.to(self.dtype) * BOHR2ANG)
                e, f = e.double() * EV2AU, f.double() * F_EVAA_2_AU
            return torch.cat([f.reshape(coords.shape[0], -1),
                              e.reshape(-1, 1)], 1)

        def fn(coords_batch):
            out = self._over_data(coords_batch, run, chunk)
            B = coords_batch.shape[0]

            def count(n):
                self.force_calls += B * n

            # at once, or once per cycle a device loop's graph took effect
            per_cycle(count)
            return (out[:, -1].contiguous(),
                    out[:, :-1].reshape(coords_batch.shape))

        fn.collective = self._one_by_one() or data_size(self.mesh) > 1
        self._batch_closure = (self.params, fn)
        return fn

    def au_hvp_fn_p(self):
        """(coords_bohr_pad [P, 3], v_pad [P, 3], packed) -> H v [P, 3], the
        JAX package's ``au_hvp_p``: the Hessian of the energy in
        Angstrom (eV/Angstrom^2) times v, frozen and padding rows zeroed;
        direction-exact in Bohr space too (the two differ by a positive
        factor). ``packed = calc.pack()``. The last point's graph is kept:
        repeated products at one coordinate tensor (a Lanczos run) share
        one forward and first backward. The graph is dropped with that
        tensor. Counts no force call."""
        state = {}

        def fn(coords_bohr_pad, v_pad, packed):
            system, params = packed
            hit = state.get("x")
            if not (hit is not None and hit[0]() is coords_bohr_pad
                    and hit[1] == coords_bohr_pad._version
                    and hit[2] is system and hit[3] is params):
                state.clear()
                c = coords_bohr_pad.to(self.dtype) * BOHR2ANG
                state["x"] = (weakref.ref(coords_bohr_pad),
                              coords_bohr_pad._version, system, params)
                state["graph"] = self._grad_graph(c, system, params)
                weakref.finalize(coords_bohr_pad, state.clear)
            c, g = state["graph"]
            hv = self._vjp(c, g, v_pad.reshape(c.shape).to(c.dtype))
            return (hv * system.free_mask[:, None].to(hv.dtype)).detach()

        return fn

    def au_hvp_fn(self):
        """Bound HVP closure (coords_pad, v_pad) -> H v, one per
        (calculator, params)."""
        cached = getattr(self, "_hvp_closure", None)
        if cached is not None and cached[0] is self.params:
            return cached[1]
        hvp_p = self.au_hvp_fn_p()
        packed = self.pack()

        def fn(coords_pad, v_pad):
            return hvp_p(coords_pad, v_pad, packed)

        fn.collective = self._one_by_one()
        self._hvp_closure = (self.params, fn)
        return fn

    def pad_bohr(self, coords_bohr) -> torch.Tensor:
        """[N, 3] or [3N] Bohr -> padded [P, 3] float64 tensor on device."""
        c = np.asarray(coords_bohr, dtype=np.float64).reshape(-1, 3)
        out = np.zeros((self.n_pad, 3), dtype=np.float64)
        out[: self.n_atoms] = c
        return torch.as_tensor(out, device=self.device)

    def unpad(self, coords_pad) -> np.ndarray:
        if isinstance(coords_pad, torch.Tensor):
            coords_pad = coords_pad.detach().cpu().numpy()
        return np.asarray(coords_pad, dtype=np.float64)[: self.n_atoms]
