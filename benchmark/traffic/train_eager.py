"""Eager training, batch 1: what a user's training run does.

Parameters (the cell's workload file): ``frames``, the distinct frames
kept on the device; ``checked_steps``, the first steps of the run that
the reference follows. Weights: ``benchmark/weights.py``.

Each step takes one frame and one observed view as its target, drawn as
``train_from_config``'s loader draws them: the frames in a fresh shuffle
each epoch, the view uniformly among the observed ones. The steps go
through ``make_train_step`` on a ``build_model`` model with
``create_train_state``'s Adam. Set-up makes the weights and frames, and
runs the checked steps through the same call and feed as the window: they
build every kernel and warm every shape. Each step ends on the device (the
step reads its selection's flag back).

``correct`` compares, against the reference run over the same frames
from the same weights: each checked step's loss, the norm of each leaf's
first gradient as Adam holds it after step 1, and the norm of each leaf's
change after the checked steps (``benchmark/compare.py``).
"""

from __future__ import annotations

import time

import torch

from benchmark import compare, counts, program
from benchmark.reference import train as reference
from benchmark.reference.model import Spec


class Session:
    kind = "train"

    def __init__(self, cell, seed: int, device):
        from pose_splatter_torch.train.loop import create_train_state, make_train_step

        w = cell.workload
        self.cell, self.seed, self.device = cell, seed, device
        t0 = time.perf_counter()
        self.spec = Spec(cell.config)
        self.inputs = program.Inputs(self.spec, seed, int(w["frames"]), device)
        t1 = time.perf_counter()
        self.model = program.build(cell.config, self.inputs)
        t2 = time.perf_counter()
        state = create_train_state(self.model, self.spec.lr)
        self.optimizer = state.optimizer
        self.state = state
        self.step_fn = make_train_step(self.model, self.optimizer,
                                       self.spec.img_lambda,
                                       self.spec.ssim_lambda, batch_size=1)
        obs = self.spec.observed
        self.view_dev = [torch.tensor([v], device=device) for v in obs]
        self.obs_dev = [torch.tensor([k], device=device) for k in range(len(obs))]
        self.schedule_gen = torch.Generator()
        self.schedule_gen.manual_seed(seed + program.SCHEDULE_STREAM)
        self.pending = []
        self.totals = []
        self.attempted = self.failed = 0
        self.flops_per_unit = counts.model_flops(self.spec, train=True)
        self._checked(int(w["checked_steps"]))
        self.finish()
        print(f"set-up: inputs {t1 - t0:.3f} s, model {t2 - t1:.3f} s, checked "
              f"steps {time.perf_counter() - t2:.3f} s", flush=True)

    # -- the feed -----------------------------------------------------------
    def _draw(self):
        """The next (frame, observed-view position) of the schedule."""
        if not self.pending:
            n = self.inputs.mask.shape[0]
            perm = torch.randperm(n, generator=self.schedule_gen).tolist()
            views = torch.randint(len(self.spec.observed), (n,),
                                  generator=self.schedule_gen).tolist()
            self.pending = list(zip(perm, views))[::-1]
        return self.pending.pop()

    def _step(self):
        i, k = self._draw()
        inp = self.inputs
        batch = dict(mask=inp.mask[i:i + 1], img=inp.img[i:i + 1],
                     p_3d=inp.p_3d[i:i + 1], angle=inp.angle[i:i + 1],
                     view_idx=self.view_dev[k], obs_idx=self.obs_dev[k])
        self.state, metrics = self.step_fn(self.state, batch)
        return (i, k), metrics

    def _checked(self, n: int):
        """The first ``n`` steps, with what the reference follows."""
        params = dict(self.model.net.named_parameters())
        w0 = self.inputs.weights()
        self.checked = []
        self.prog = dict(losses=[], grad_norms={}, change_norms={})
        for t in range(n):
            (i, k), m = self._step()
            self.checked.append((i, k))
            self.prog["losses"].append(float(m["total"]))
            if t == 0:
                for name, p in params.items():
                    st = self.optimizer.state.get(p, {})
                    g = st.get("exp_avg")
                    self.prog["grad_norms"][name] = (
                        None if g is None else float((g / 0.1).norm()))
        for name, p in params.items():
            self.prog["change_norms"][name] = float((p.detach() - w0[name]).norm())
        del w0

    # -- the window ---------------------------------------------------------
    def unit(self):
        self.attempted += 1
        try:
            _, m = self._step()
        except RuntimeError:
            self.failed += 1
            return
        self.totals.append(m["total"])

    def finish(self):
        if self.device != "cpu":
            torch.cuda.synchronize(self.device)

    def window(self, seconds: float) -> dict:
        self.finish()
        t0, n = time.perf_counter(), 0
        while time.perf_counter() - t0 < seconds:
            self.unit()
            n += 1
        self.finish()
        elapsed = time.perf_counter() - t0
        return {"train_step_ms": 1e3 * elapsed / n}

    # -- after the window ---------------------------------------------------
    def release(self):
        if self.totals:
            bad = int((~torch.isfinite(torch.stack(self.totals))).sum())
            self.failed += bad
        inp = self.inputs
        self.ref_steps = [dict(inp.frame(i), view=self.spec.observed[k], obs=k)
                          for i, k in self.checked]
        self.ref_steps = [{k: (v.clone() if torch.is_tensor(v) else v)
                           for k, v in s.items()} for s in self.ref_steps]
        self.cameras = inp.cameras()
        self.grid = inp.grid
        del self.model, self.optimizer, self.state, self.step_fn, self.totals
        inp.mask = inp.img = None
        program.free_cuda()

    def reference(self, lr=None) -> dict:
        weights = self.inputs.weights()
        return reference.train_steps(weights, self.spec, self.cameras, self.grid,
                                     self.ref_steps,
                                     self.spec.lr if lr is None else lr)

    def check(self) -> dict:
        return compare.train_checks(self.prog, self.reference(),
                                    self.cell.workload["limits"])
