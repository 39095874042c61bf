"""K train steps a call, batch 1: the port's quality benchmark's loop
(``scripts/synthetic_benchmark.py --steps-per-call K``).

Parameters (the cell's workload file): ``frames`` and the limits as in
``train_eager``; ``steps_per_call``, the K of ``make_train_multi_step``;
``checked_steps``, the first steps of the run that the reference follows,
a whole number of calls.

The frames stay on the device and each step takes one frame and one
observed view as its target, drawn by ``train_eager``'s schedule, K draws
a call. The calls go through ``make_train_multi_step`` on a ``build_model``
model with ``create_train_state``'s Adam: on the card the first
``WARMUP_STEPS`` steps run eagerly, then one step is captured as a CUDA
graph and every later step is a replay. Set-up runs the checked calls,
which take the warm-up steps, the capture and replays, so every shape is
warm before the window. Each call ends on the device (the call reads its
selection's flag back); ``train_step_ms`` is the window over the steps
its calls completed.

``correct`` compares every step the program took in the checked calls,
the eager warm-up steps included, with the reference run over the same
frames from the same weights: each step's loss, each leaf's first
gradient as Adam holds it after step 1 (read by a hook on the optimizer's
first step, before any capture) and each leaf's change after the checked
calls (``benchmark/compare.py``).

A K-step call refuses to run inside ``stages.record()``, whose marks
synchronise. In the traced run's marked part, the units run there are
therefore eager steps (``make_train_step``) on the same model, optimizer
and schedule; the FLOP rate and the profiled part run K-step calls.
"""

from __future__ import annotations

import time

from benchmark.traffic import train_eager


class Session(train_eager.Session):
    kind = "train"

    def __init__(self, cell, seed: int, device):
        self.steps_per_call = int(cell.workload["steps_per_call"])
        super().__init__(cell, seed, device)
        self.flops_per_unit *= self.steps_per_call

    # -- the feed -----------------------------------------------------------
    def _call(self):
        """One K-step call on the next K draws of the schedule."""
        draws = [self._draw() for _ in range(self.steps_per_call)]
        obs = self.spec.observed
        self.state, metrics = self.multi(
            self.state, [i for i, _ in draws], [obs[k] for _, k in draws],
            [k for _, k in draws])
        return draws, metrics

    def _checked(self, n: int):
        """The first ``n`` steps, in calls of K, with what the reference
        follows; builds the K-step call (on the frames already on the
        device, with no copy)."""
        from pose_splatter_torch.train.loop import make_train_multi_step

        calls, rest = divmod(n, self.steps_per_call)
        if rest or not calls:
            raise ValueError(f"checked_steps {n} is not a whole number of "
                             f"calls of {self.steps_per_call} steps")
        inp = self.inputs
        self.multi = make_train_multi_step(
            self.model, self.optimizer, self.spec.img_lambda,
            self.spec.ssim_lambda,
            dict(mask=inp.mask, img=inp.img, p_3d=inp.p_3d, angle=inp.angle),
            self.steps_per_call)
        names = {p: name for name, p in self.model.net.named_parameters()}
        w0 = self.inputs.weights()
        self.checked = []
        self.prog = dict(losses=[], grad_norms={}, change_norms={})
        first = {}

        def after_first_step(optimizer, args, kwargs):
            handle.remove()
            for p, name in names.items():
                g = optimizer.state.get(p, {}).get("exp_avg")
                first[name] = None if g is None else (g / 0.1).norm()

        handle = self.optimizer.register_step_post_hook(after_first_step)
        try:
            for _ in range(calls):
                draws, _ = self._call()
                self.checked.extend(draws)
                self.prog["losses"].extend(
                    float(x) for x in self.multi.step_metrics["total"].tolist())
        finally:
            handle.remove()
        self.prog["grad_norms"] = {name: None if g is None else float(g)
                                   for name, g in first.items()}
        for name, p in self.model.net.named_parameters():
            self.prog["change_norms"][name] = float((p.detach() - w0[name]).norm())
        del w0

    # -- the window ---------------------------------------------------------
    def unit(self):
        """One K-step call; inside ``stages.record()`` one eager step."""
        from pose_splatter_torch.utils import stages

        if stages.recording():
            return super().unit()
        self.attempted += 1
        try:
            _, m = self._call()
        except RuntimeError:
            self.failed += 1
            return
        self.totals.append(m["total"])

    def window(self, seconds: float) -> dict:
        self.finish()
        t0, n = time.perf_counter(), 0
        while time.perf_counter() - t0 < seconds:
            self.unit()
            n += 1
        self.finish()
        elapsed = time.perf_counter() - t0
        return {"train_step_ms": 1e3 * elapsed / (n * self.steps_per_call)}

    def release(self):
        self.multi = None  # its graph and its references to the frames
        super().release()
