"""Copy of libde265_tpu/encoder/ratectrl.py (the port keeps its own
copies of the host modules and imports nothing of the JAX package).

Rate control: per-frame QP adaptation to a target bitrate.

The reference encoder is fixed-QP only (EncoderCore_Custom has no rate
control; rd-curves sweeps QPs externally), so this extends parity: a
TM5-style virtual-buffer controller — each frame's QP is the base QP
plus a correction proportional to the buffer fullness (accumulated
overshoot), with intra frames granted a larger share of the budget.
Signaled losslessly via slice_qp_delta (PPS init_qp stays cfg.qp).
"""


class RateController:
    INTRA_WEIGHT = 3.0         # intra frames get 3x the per-frame budget
    GAIN = 6.0                 # QP steps per 100% buffer-of-budget error
    MAX_STEP = 4               # max per-frame QP change

    def __init__(self, bitrate_kbps, fps, base_qp, intra_period=0,
                 n_frames=None):
        self.budget = bitrate_kbps * 1000.0 / max(fps, 1e-9)  # bits/frame
        # normalize weights so a GOP still averages to the budget
        if intra_period and intra_period > 0:
            per = intra_period
            self.w_intra = self.INTRA_WEIGHT * per / \
                (per - 1 + self.INTRA_WEIGHT)
            self.w_inter = per / (per - 1 + self.INTRA_WEIGHT)
        else:
            self.w_intra = self.INTRA_WEIGHT
            self.w_inter = 1.0
        self.base_qp = base_qp
        self.fullness = 0.0        # bits of accumulated overshoot
        self.prev_qp = base_qp

    def qp_for_frame(self, is_intra):
        err = self.fullness / max(self.budget, 1.0)
        qp = self.base_qp + self.GAIN * err
        qp = max(self.prev_qp - self.MAX_STEP,
                 min(self.prev_qp + self.MAX_STEP, qp))
        qp = int(round(max(1, min(51, qp))))
        self.prev_qp = qp
        return qp

    def update(self, bits_used, is_intra):
        w = self.w_intra if is_intra else self.w_inter
        self.fullness += bits_used - w * self.budget
        # slow base-QP drift so steady-state error goes to zero
        if self.fullness > 4 * self.budget:
            self.base_qp = min(51, self.base_qp + 1)
            self.fullness -= self.budget
        elif self.fullness < -4 * self.budget:
            self.base_qp = max(1, self.base_qp - 1)
            self.fullness += self.budget
