"""The reference's training step: loss, gradients and Adam, in float32.

The loss is the reference implementation's: masked MSE of the mel before
and after the postnet, the stop head's weighted cross-entropy, each a mean
over the batch's unpadded frames, and 5e-9 x the L2 of the dense and
convolution weights.  Adam follows Kingma & Ba with the reference's
epsilon and learning-rate schedule.

The step runs in blocks of rows so that it fits on the card beside nothing
else at the sizes the program trains at.  Only the postnet couples rows
(its batch norm takes the statistics of the whole batch), so the step runs
in three passes: (A) the encoder and decoder of every block without
gradients, giving the mel before the postnet; (B) the postnet and both mel
losses over the whole batch, with gradients, giving the gradient of the
loss in the mel before the postnet; (C) the encoder and decoder of every
block again, back-propagating that gradient and the stop loss.
"""

from __future__ import annotations

import torch

from . import model as M


def rows_per_block(b, t_in, t_out, hp, budget_bytes):
    """Rows whose float32 activations fit ``budget_bytes``: per decoder
    layer about five [heads, T, T + T_in] attention tensors and forty
    [T, width] activations a row, and the same for the encoder."""
    heads = hp.n_attention_head
    per_row = hp.n_decoder_layer * t_out * 4 * (
        5 * heads * (t_out + t_in) + 40 * hp.decoder_hidden) + \
        hp.n_encoder_layer * t_in * 4 * (
            5 * heads * t_in + 40 * hp.encoder_hidden)
    if budget_bytes is None:
        return b
    return max(1, min(b, int(budget_bytes // per_row)))


def lr_at(step: int, hp) -> float:
    """The learning rate of 0-based step ``step``: max_lr, decayed
    exponentially after the warm-up, floored at min_lr."""
    s = max(step - hp.warmup_steps, 0)
    rate = hp.lr_decay_rate ** (s / hp.lr_decay_step)
    return hp.max_lr * max(hp.min_lr / hp.max_lr, rate)


def step_grads(P, hp, batch, drops, Q=M.exact, rows=None, budget=None):
    """Loss terms and gradients of one training step over ``batch`` (the
    reference's own padded batch, on the device).  The parameters of ``P``
    that require gradients get ``.grad``; returns the loss terms as
    floats."""
    inputs, il = batch["inputs"], batch["input_lengths"]
    mel, tl = batch["mel_targets"], batch["target_lengths"]
    spk, lvec = batch.get("input_spk_ids"), batch.get("input_language_vecs")
    b, t_out = mel.shape[:2]
    count = tl.sum()
    blk = rows or rows_per_block(b, inputs.shape[1], t_out, hp, budget)
    for p in P.values():
        p.grad = None

    def forward(r0, r1):
        sl = slice(r0, r1)
        d = drops.rows(r0, r1)
        mem = M.encoder(P, hp, inputs[sl], il[sl],
                        None if spk is None else spk[sl],
                        None if lvec is None else lvec[sl], Q, d)
        return M.decoder_teacher_forced(P, hp, mem, il[sl], mel[sl], tl[sl],
                                        Q, d)

    mel_bef = torch.empty_like(mel)
    stop_sum = 0.0
    with torch.no_grad():
        for r0 in range(0, b, blk):
            m, s = forward(r0, min(b, r0 + blk))
            mel_bef[r0:r0 + blk] = m
            stop_sum = stop_sum + M.stop_loss_sum(s, tl[r0:r0 + blk])

    mb = mel_bef.requires_grad_()
    aft = mb + M.postnet(P, hp, mb, tl, train=True, Q=Q,
                         drop=drops.rows(0, b))
    bef_loss = M.masked_mean(torch.square(mb - mel).mean(-1), tl, count)
    aft_loss = M.masked_mean(torch.square(aft - mel).mean(-1), tl, count)
    (bef_loss + aft_loss).backward()
    g_mel = mb.grad

    for r0 in range(0, b, blk):
        r1 = min(b, r0 + blk)
        m, s = forward(r0, r1)
        ((g_mel[r0:r1] * m).sum() +
         M.stop_loss_sum(s, tl[r0:r1]) / count).backward()
    l2 = M.l2_term({n: p for n, p in P.items() if p.requires_grad}, hp)
    l2.backward()
    stop_loss = float(stop_sum / count)
    bef, aft_, l2v = (float(t.detach()) for t in (bef_loss, aft_loss, l2))
    return {"loss": bef + aft_ + l2v + stop_loss, "bef_loss": bef,
            "aft_loss": aft_, "stop_loss": stop_loss, "l2": l2v}


class Adam:
    """Adam over the parameters of ``P`` that require gradients."""

    def __init__(self, P, hp):
        self.P = {n: p for n, p in P.items() if p.requires_grad}
        self.hp = hp
        self.m = {n: torch.zeros_like(p) for n, p in self.P.items()}
        self.v = {n: torch.zeros_like(p) for n, p in self.P.items()}
        self.t = 0

    @torch.no_grad()
    def step(self):
        hp = self.hp
        b1, b2 = hp.adam_beta1, hp.adam_beta2
        lr = lr_at(self.t, hp)
        self.t += 1
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for n, p in self.P.items():
            g = p.grad
            if g is None:
                continue
            self.m[n].mul_(b1).add_(g, alpha=1 - b1)
            self.v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = self.v[n].sqrt() / c2 ** 0.5 + hp.adam_eps
            p.addcdiv_(self.m[n], denom, value=-lr / c1)
