"""Pipeline-parallel WaveGlow training: a GPipe schedule over a ``pp`` axis.

Counterpart of ``text_to_speech_tpu/parallel/pipeline.py``.  The flow stack
is cut into ``n_stages`` contiguous stages (`stage_bounds`), one for each
rank of the ``pp`` group, and the batch into ``n_micro`` microbatches that
stream through them.  As in the JAX design, the activation that travels is
the FULL ``(micro, Lg, n_group)`` group buffer: the channels an early
output freezes simply stop being touched, so at the last stage the buffer
is ``z``, and the NLL needs only ``sum(z²)``, the accumulated ``log_s``
and the 1×1 convs' log-determinants, which travel beside it.

The JAX pipeline is one differentiable program (the transpose of
`ppermute` carries the gradients back).  PyTorch's autograd does not
differentiate through `send`/`recv`, so the schedule is explicit:

  1. forward: each stage receives microbatch m from the stage before (the
     first builds it from the audio), runs its flows, sends the result on
     and keeps its inputs and outputs;
  2. backward, microbatches in reverse: the last stage starts from the
     NLL, every other stage receives the gradient of its outputs from the
     stage after and runs ``torch.autograd.backward(outputs, grads)``, then
     sends the gradient of its inputs to the stage before;
  3. the parameter gradients are summed over ``pp`` (a flow's gradient
     lives on its stage; every stage upsamples the mel itself, so the
     upsample's gradient is the sum over the stages) and over ``dp``.

An optional ``dp`` axis shards each microbatch's rows.  The loss is the
global batch's NLL per element, equal to `arch.loss` up to summation
order.  Under a mixed `compute_dtype` the flows but their 1×1 convs run
in it and every sum stays float32, as in `waveglow_arch.forward`.
"""

import torch

from . import collectives
from ..train.optimizers import _leaves
from ..train.precision import cast_floating

__all__ = ['stage_bounds', 'WaveGlowPipeline']


def stage_bounds(n_flows, n_stages):
    """Contiguous, near-equal partition of ``range(n_flows)`` into stages:
    [b_0=0, b_1, ..., b_S=n_flows]."""
    if not 1 <= n_stages <= n_flows:
        raise ValueError('need 1 <= n_stages ({}) <= n_flows ({})'.format(n_stages, n_flows))
    base, extra = divmod(n_flows, n_stages)
    bounds = [0]
    for s in range(n_stages):
        bounds.append(bounds[-1] + base + (1 if s < extra else 0))
    return bounds


class WaveGlowPipeline:
    """The pipelined NLL of a `models.waveglow_arch.WaveGlow` over `mesh`,
    which carries the `axis` ('pp') dimension; a `dp_axis` present in the
    mesh shards the microbatches' rows.  ``n_micro`` (default 2 × the
    stages) microbatches must divide the global batch."""

    def __init__(self, arch, mesh, *, axis = 'pp', dp_axis = None, n_micro = None):
        self.arch = arch
        self.mesh = mesh
        self.axis = axis
        self.dp_axis = dp_axis if dp_axis in mesh.shape else None
        self.n_stages = mesh.shape[axis]
        self.n_micro = n_micro if n_micro is not None else 2 * self.n_stages
        self.bounds = stage_bounds(arch.hp.n_flows, self.n_stages)
        self.stage = mesh.coords[axis]
        ranks = mesh.group_ranks(axis)
        self.prev = ranks[self.stage - 1] if self.stage > 0 else None
        self.next = ranks[self.stage + 1] if self.stage < self.n_stages - 1 else None

    def _run_stage(self, params, buffer, spect, log_s, logdet):
        """This rank's flows [lo, hi) on the carried full-group buffer."""
        arch, n_group = self.arch, self.arch.hp.n_group
        rows = buffer.shape[0] * buffer.shape[1]                 # Bm * Lg
        for k in range(self.bounds[self.stage], self.bounds[self.stage + 1]):
            c = arch.flow_channels[k]
            off = n_group - c
            flow = params['flow_{}'.format(k)]
            w = flow['convinv']['weight']
            active = buffer[..., off:] @ w.T
            ld = torch.linalg.slogdet(w)[1]
            n_half = c // 2
            a0, a1 = active[..., :n_half], active[..., n_half:]
            wn_out = arch.wn_block(flow['block'], a0.to(spect.dtype), spect, fused = False)
            b, s = wn_out[..., :n_half], wn_out[..., n_half:].float()
            a1 = torch.exp(s) * a1 + b.float()
            buffer = torch.cat([buffer[..., :off], a0, a1], dim = -1)
            log_s = log_s + s.sum()
            logdet = logdet + rows * ld
        return buffer, log_s, logdet

    def _local_rows(self, x):
        """This rank's dp rows of each microbatch: (n_micro, bm_local, ...)."""
        x = x.reshape((self.n_micro, x.shape[0] // self.n_micro) + tuple(x.shape[1:]))
        if self.dp_axis is None:
            return x
        n, i = self.mesh.shape[self.dp_axis], self.mesh.coords[self.dp_axis]
        rows = x.shape[1] // n
        return x[:, i * rows: (i + 1) * rows]

    def value_and_grad(self, params, mel, audio, sigma = None, *, compute_dtype = None):
        """The global batch's NLL per element (on every rank) and its
        gradient in each leaf's ``.grad`` (summed over ``pp`` and ``dp``,
        the same on every rank).  `params`: leaf tensors that require
        gradients; `mel`, `audio`: the global batch, the same on every
        rank."""
        arch, hp = self.arch, self.arch.hp
        sigma = hp.sigma if sigma is None else sigma
        B = audio.shape[0]
        if B % self.n_micro:
            raise ValueError('batch {} not divisible into {} microbatches'.format(
                B, self.n_micro))
        if self.dp_axis is not None and (B // self.n_micro) % self.mesh.shape[self.dp_axis]:
            raise ValueError('microbatch of {} rows does not divide over {} = {}'.format(
                B // self.n_micro, self.dp_axis, self.mesh.shape[self.dp_axis]))
        run_params = params
        if compute_dtype is not None and compute_dtype != torch.float32:
            run_params = cast_floating(params, compute_dtype, exempt = ('convinv',))
            mel = mel.to(compute_dtype)
        mels = self._local_rows(mel)
        n_micro, bm = mels.shape[0], mels.shape[1]
        # every stage conditions its own flows: the upsample runs once for
        # its rows, its gradient gathered from each microbatch's leaf
        spect = arch.upsample_mel(run_params, mels.reshape((-1,) + tuple(mels.shape[2:])))
        lg = spect.shape[1]
        spect = spect.reshape((n_micro, bm) + tuple(spect.shape[1:]))
        spect_leaves = [spect[m].detach().requires_grad_(True) for m in range(n_micro)]
        buffers = self._local_rows(audio[:, : lg * hp.n_group].reshape(B, lg, hp.n_group))
        n_elems = B * lg * hp.n_group
        inv_2s2 = 1. / (2. * sigma * sigma)
        group = self.mesh.group(self.axis)
        device, first, last = audio.device, self.prev is None, self.next is None
        shape = (bm, lg, hp.n_group)
        zero = torch.zeros((), device = device)

        saved, nll_sum = [], zero
        for m in range(n_micro):
            if first:
                inputs = (buffers[m].float(), zero, zero)
            else:
                packed = collectives.recv((bm * lg * hp.n_group + 2,), torch.float32, device,
                                          self.prev, group)
                inputs = tuple(t.requires_grad_(True) for t in (
                    packed[:-2].view(shape).clone(), packed[-2].clone(), packed[-1].clone()))
            outputs = self._run_stage(run_params, * inputs[:1], spect_leaves[m], * inputs[1:])
            if last:
                buffer, log_s, logdet = outputs
                nll = torch.sum(buffer.float() ** 2) * inv_2s2 - log_s - logdet
                nll_sum = nll_sum + nll.detach()
                outputs = nll / n_elems
            else:
                collectives.send(torch.cat([outputs[0].detach().reshape(-1),
                                            outputs[1].detach().reshape(1),
                                            outputs[2].detach().reshape(1)]), self.next, group)
            saved.append((inputs, outputs))

        for m in reversed(range(n_micro)):
            inputs, outputs = saved[m]
            if last:
                torch.autograd.backward(outputs)
            else:
                grads = collectives.recv((bm * lg * hp.n_group + 2,), torch.float32, device,
                                         self.next, group)
                torch.autograd.backward(list(outputs), [grads[:-2].view(shape), grads[-2],
                                                        grads[-1]])
            if not first:
                collectives.send(torch.cat([
                    (t.grad if t.grad is not None else torch.zeros_like(t)).reshape(-1)
                    for t in inputs]), self.prev, group)
            saved[m] = None
        torch.autograd.backward(spect, torch.stack([
            t.grad if t.grad is not None else torch.zeros_like(t) for t in spect_leaves]))

        leaves = _leaves(params)
        collectives.average_gradients(leaves, group, average = False)
        loss = nll_sum.reshape(1)
        collectives.all_reduce_(loss, group)
        if self.dp_axis is not None:
            dp_group = self.mesh.group(self.dp_axis)
            collectives.average_gradients(leaves, dp_group, average = False)
            collectives.all_reduce_(loss, dp_group)
        return loss[0] / n_elems

    def train_step(self, optimizer, *, sigma = None, compute_dtype = None):
        """``step(params, opt_state, mel, audio) → (params, opt_state,
        loss)``; `opt_state` is ``optimizer.init(params)`` and updates
        `params` in place."""
        def step(params, opt_state, mel, audio):
            opt_state.zero_grad()
            loss = self.value_and_grad(params, mel, audio, sigma, compute_dtype = compute_dtype)
            opt_state.step()
            return params, opt_state, loss
        return step
