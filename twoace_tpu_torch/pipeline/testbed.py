"""Testbed campaign orchestration, the ``main.py`` driver as a library
(port of ``twoace_tpu.pipeline.testbed``).

The reference's end-to-end testbed run (ref: main/main.py:26-483): five
probing campaigns (thetaNphi sweep, phi sweep, directional, random,
multires) against a measurement provider, then estimation over the
probe-budget grid and a beamforming comparison of the recovered channels.

Hardware specifics (SSH, firmware reloads, .brd flashing) live behind the
``MeasurementProvider`` protocol (``provider.measure(rows) -> RSS dBm``);
the campaign mechanics are kept: per-round incremental checkpointing, the
thermal guard, multires tier ordering.  The probe rows are built on the
runner's device (the card unless the caller asks for the CPU) and handed
to the provider as tensors; a campaign's rows stay there for
:meth:`TestbedRunner.estimate`, whose recovery entries solve on the rows'
device.  Draws come from ``fold_in`` of the runner's generator: 4 for the
random campaign, 5 for multires, 6 for the evaluation probes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..config import ArrayConfig
from ..interop import resolve_device
from ..sensing.codebooks import (
    Codebook,
    aco_sweep_codebook,
    conj_phase_bits,
    directional_beams_angular,
    evaluation_codebook,
    kron_probe_rows,
    multires_codebook,
    phase_rows,
    random_codebook,
    rss_to_csi,
    svd_beamformer_bits,
    sweep_codebook,
    sweep_codebook_2d,
)
from ..sensing.provider import MeasurementProvider, ThermalGuard
from ..utils.checkpoint import CampaignStore
from ..utils.rng import fold_in
from .recovery import (
    CampaignConfig,
    recover_a2nuclear,
    recover_a2only,
    recover_directional,
    recover_multiresolution,
    recover_phaselift,
)

#: the recovery entry behind each ``estimate`` method name
RECOVER = {"a2only": recover_a2only, "a2nuclear": recover_a2nuclear,
           "multiresolution": recover_multiresolution,
           "phaselift": recover_phaselift,
           "directional": recover_directional}


@dataclasses.dataclass
class TestbedConfig:
    """Probe counts of the reference campaigns (ref: main.py:28-81)."""

    __test__ = False            #: not a pytest test class

    array: ArrayConfig = ArrayConfig()
    n_theta_phi: int = 36       #: elevation+azimuth sweep rounds
    n_phi: int = 32             #: azimuth sweep rounds
    n_directional: int = 32     #: directional rounds (x sectors)
    n_random_rounds: int = 64   #: random codebook rounds
    sectors_per_round: int = 62
    multires_rounds: Sequence[int] = (32, 64, 64)
    n_repeats: int = 2          #: estimation repeats (ref: 40)
    checkpoint_dir: Optional[str] = None


def _bits_codebook(bits, n_ant: int, phase_bit: int, device) -> Codebook:
    """A codebook of given (entries, n_ant) bits (tests hand over JAX's)."""
    bits = torch.tensor(np.asarray(bits), dtype=torch.int64, device=device)
    return Codebook(bits=bits, amp=torch.ones(n_ant, device=device),
                    phase_bit=phase_bit)


class TestbedRunner:
    """The five campaigns, estimation and evaluation against one provider.

    ``generator``: the campaigns' draws (seed 0 when None); ``device``:
    where the probe rows are built and the estimates solved (the card by
    default; it raises without one).  ``results[name]`` holds each
    measured campaign: ``rss_dbm`` (numpy, row-aligned) and ``rows`` (a
    tensor on ``device``).
    """

    __test__ = False

    def __init__(self, cfg: TestbedConfig, provider: MeasurementProvider,
                 generator: Optional[torch.Generator] = None,
                 guard: Optional[ThermalGuard] = None, device="cuda"):
        self.cfg = cfg
        self.provider = provider
        self.generator = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        self.guard = guard
        self.device = resolve_device(device)
        self.store = CampaignStore(cfg.checkpoint_dir) \
            if cfg.checkpoint_dir else None
        self.results: Dict[str, Dict[str, object]] = {}

    # ------------------------------------------------------------- campaigns

    def _measure_rounds(self, name: str, tx_rows, rx_rows,
                        interleave: bool = False) -> Dict[str, object]:
        """Measure all (round, sector) probes, one provider call a round,
        with per-round checkpointing and thermal guarding (ref:
        main.py:97-134): a round already in the store is loaded, not
        measured."""
        rounds = rx_rows.shape[0]
        sectors = tx_rows.shape[1]
        done = set(self.store.completed_rounds(name)) if self.store else set()
        rss = np.zeros((rounds, sectors))
        for i in range(rounds):
            if i in done:                       # resume from checkpoint
                rss[i] = self.store.load(name, i)["rss"]
                continue
            rows = kron_probe_rows(tx_rows[i:i + 1], rx_rows[i:i + 1])
            rss[i] = self.provider.measure(rows)
            if self.guard is not None:
                self.guard.wait_until_cool()    # ref: main.py:120-132
            if self.store:
                self.store.save(name, {"rss": rss[i]}, i)
        rows_all = kron_probe_rows(tx_rows, rx_rows, interleave=interleave)
        # sector-major rows under interleave, so the RSS follows them
        rss_flat = rss.T.reshape(-1) if interleave else rss.reshape(-1)
        out = {"rss_dbm": rss_flat, "rows": rows_all}
        self.results[name] = out
        return out

    def run_sweep_campaigns(self):
        """Campaigns 1-2: elevation/azimuth sweeps (ref: main.py:97-177),
        one sweep beam per round on both sides (single sector)."""
        cfg = self.cfg.array
        n_el = max(1, int(round(self.cfg.n_theta_phi ** 0.5)))
        theta_cb = sweep_codebook_2d(cfg, self.cfg.n_theta_phi // n_el, n_el,
                                     device=self.device)
        for name, cb in (("theta_phi", theta_cb),
                         ("phi", sweep_codebook(cfg, self.cfg.n_phi,
                                                device=self.device))):
            rows_side = cb.rows()
            self._measure_rounds(name, rows_side[:, None, :],
                                 torch.conj(rows_side))   # combiner side
        return self

    def run_random_campaign(self, tx_bits=None, rx_bits=None):
        """Campaign 4: random probing, 64 rounds x 62 Tx sectors
        (ref: main.py:241-302, generate_rx_codebook_16ant_random.py).
        The Tx bits come from ``fold_in(fold_in(generator, 4), 0)``, the Rx
        bits from ``fold_in(.., 1)`` (``tx_bits``/``rx_bits`` replace
        them; tests hand over JAX's)."""
        cfg = self.cfg.array
        g = fold_in(self.generator, 4)
        rounds, sectors = self.cfg.n_random_rounds, self.cfg.sectors_per_round
        tx_cb = random_codebook(fold_in(g, 0), rounds * sectors, cfg.nt,
                                cfg.phase_bit, self.device) \
            if tx_bits is None else _bits_codebook(tx_bits, cfg.nt,
                                                   cfg.phase_bit, self.device)
        rx_cb = random_codebook(fold_in(g, 1), rounds, cfg.nr, cfg.phase_bit,
                                self.device) \
            if rx_bits is None else _bits_codebook(rx_bits, cfg.nr,
                                                   cfg.phase_bit, self.device)
        # round-fastest ordering, matching the shipped random_probe_cb row
        # layout (processsing_codebook_random.m:54-62 reshape without
        # permute)
        self._measure_rounds("random",
                             tx_cb.rows().reshape(rounds, sectors, cfg.nt),
                             rx_cb.rows(), interleave=True)
        return self

    def run_directional_campaign(self):
        """Campaign 3: directional sectors, n_directional Rx beams x
        n_directional Tx sectors (ref: main.py:183-220)."""
        cfg = self.cfg.array
        nd = self.cfg.n_directional
        f, w = directional_beams_angular(nd, nd, cfg, (-90.0, 90.0),
                                         (-90.0, 90.0), device=self.device)
        tx = f.T[None].expand(nd, nd, cfg.nt)        # all Tx sectors a round
        self._measure_rounds("directional", tx, w.T)  # one Rx beam a round
        return self

    def collect_aco(self, tx_bits=None, rx_bits=None):
        """ACO calibration: per-antenna phase sweeps on each side, one
        provider call a probe, 2^b-point DFT phase recovery, conjugate
        2-bit codeword.

        ref: main.py:398-419 -> codebook_library.py collect_ACO_tx
        (:528-582), collect_ACO_rx (:164-190), rss2csi (:518-526),
        get_ACO_codebook_bit (:584-591).  ``tx_bits``/``rx_bits``: the
        far-side beams held during the sweep (default the all-zeros
        sector).  Returns ``(wt_aco_bits, wr_aco_bits)`` on the device.
        """
        cfg = self.cfg.array
        dev = self.device
        if tx_bits is None:
            tx_bits = torch.zeros(cfg.nt, dtype=torch.int64, device=dev)
        if rx_bits is None:
            rx_bits = torch.zeros(cfg.nr, dtype=torch.int64, device=dev)
        tx_fixed = phase_rows(torch.as_tensor(tx_bits, device=dev),
                              cfg.phase_bit, normalize_by=cfg.nt)
        rx_fixed = phase_rows(torch.as_tensor(rx_bits, device=dev),
                              cfg.phase_bit, normalize_by=cfg.nr)
        out_bits = []
        for side, n_ant, far in (("rx", cfg.nr, tx_fixed),
                                 ("tx", cfg.nt, rx_fixed)):
            masks = aco_sweep_codebook(n_ant, phase_bit=cfg.phase_bit,
                                       device=dev).rows()
            n_masks = masks.shape[0]
            if side == "rx":
                rows = kron_probe_rows(far[None, None, :].expand(
                    n_masks, 1, cfg.nt), masks)
            else:
                rows = kron_probe_rows(masks[:, None, :],
                                       far[None, :].expand(n_masks, cfg.nr))
            rss_dbm = np.concatenate([self.provider.measure(rows[i:i + 1])
                                      for i in range(rows.shape[0])])
            csi = rss_to_csi(10.0 ** (torch.as_tensor(rss_dbm) / 10.0),
                             n_ant, cfg.phase_bit)
            out_bits.append(conj_phase_bits(csi, cfg.phase_bit).to(dev))
        wr_aco, wt_aco = out_bits
        if self.store:
            self.store.save("aco", {"wt_bits": wt_aco.cpu().numpy(),
                                    "wr_bits": wr_aco.cpu().numpy()})
        return wt_aco, wr_aco

    def run_multires_campaign(self, tx_bits=None, rx_bits=None):
        """Campaign 5: three-tier multires probing (ref: main.py:317-394).

        Rows use the MATLAB multires ordering (sector fastest, tiers in
        contiguous row ranges, processsing_codebook_multires.m:60-61),
        which the tier-aware sampling of ``recovery._pick_m_indices``
        assumes.  The Rx tiers draw from ``fold_in(fold_in(generator, 5),
        0)``, the Tx tiers from ``fold_in(.., 1)`` (``tx_bits``/``rx_bits``:
        the inferred tables, replacing the draws)."""
        cfg = self.cfg.array
        g = fold_in(self.generator, 5)
        rounds = tuple(self.cfg.multires_rounds)
        sectors = self.cfg.sectors_per_round
        rx_cb = multires_codebook(fold_in(g, 0), cfg.nr, rounds,
                                  cfg.phase_bit, device=self.device)[0] \
            if rx_bits is None else _bits_codebook(rx_bits, cfg.nr,
                                                   cfg.phase_bit, self.device)
        tx_cb = multires_codebook(fold_in(g, 1), cfg.nt,
                                  tuple(r * sectors for r in rounds),
                                  cfg.phase_bit, device=self.device)[0] \
            if tx_bits is None else _bits_codebook(tx_bits, cfg.nt,
                                                   cfg.phase_bit, self.device)
        self._measure_rounds(
            "multires", tx_cb.rows().reshape(sum(rounds), sectors, cfg.nt),
            rx_cb.rows(), interleave=False)
        return self

    # ------------------------------------------------------------ estimation

    def estimate(self, campaign: str = "random", method: str = "a2only",
                 seed_id: int = 1, cc: Optional[CampaignConfig] = None):
        """Recover the channel from a measured campaign over the M grid
        (ref: main.py:426-440), on the campaign rows' device."""
        data = self.results[campaign]
        kwargs = {"cc": cc} if cc is not None else {}
        out = RECOVER[method](data["rows"], data["rss_dbm"],
                              seed_id=seed_id, **kwargs)
        if self.store:
            self.store.save(f"estimate_{campaign}_{method}_{seed_id}", {
                "h_amp": out.h_amp, "h_angle": out.h_angle,
                "m_grid": np.asarray(out.m_grid)})
        return out

    def beamforming_comparison(self, h_estimates: Dict[str, object]):
        """Flash each method's SVD beamformer and measure its RSS
        (ref: main.py:452-483).  ``h_estimates``: method -> (n,) vec(H)."""
        cfg = self.cfg.array
        rss_bf: Dict[str, float] = {}
        for name, vec_h in h_estimates.items():
            # (nt, nr) orientation: vec(H) is Rx-fastest, and the beamformer
            # expects rows = Tx antennas (ref: codebook_generator reshape
            # [num_tx_ant, num_rx_ant], codebook_library.py:197)
            h = torch.as_tensor(vec_h).to(self.device).reshape(cfg.nt, cfg.nr)
            wt_bits, wr_bits = svd_beamformer_bits(h, cfg.phase_bit)
            # the reference hard-codes 2-bit steps, pi/2, here
            wt = torch.polar(torch.ones(cfg.nt, device=h.device),
                             wt_bits.to(torch.float32) * (math.pi / 2))
            wr = torch.polar(torch.ones(cfg.nr, device=h.device),
                             wr_bits.to(torch.float32) * (math.pi / 2))
            # beams enter the measurement unconjugated, matching the codebook
            # model rss = |kron(tx, rx) . vecH| (processsing_codebook_random.m
            # :54-62) that the recovery was trained under
            row = kron_probe_rows(wt[None, None, :], wr[None, :])
            rss_bf[name] = float(self.provider.measure(row)[0])
        if self.store:
            self.store.save("beamforming", {
                k: np.asarray(v) for k, v in rss_bf.items()})
        return rss_bf

    def evaluate_codebook_rss(self, h_estimates, h_directional=None,
                              aco_bits=None, compensation=None,
                              n_probe: int = 50):
        """Assemble the full on-air evaluation codebook (SVD beams per
        estimate, directional beams, ACO beam, probe sectors) and measure
        every beam's RSS (ref: main.py:452-481 + codebook_generator).
        Returns ``(rss_dbm, tx_bits, rx_bits)`` as numpy."""
        cfg = self.cfg.array
        wt_aco, wr_aco = aco_bits if aco_bits is not None else (None, None)
        tx_bits, rx_bits = evaluation_codebook(
            fold_in(self.generator, 6),
            torch.as_tensor(h_estimates).to(self.device),
            h_directional=h_directional, wt_aco_bits=wt_aco,
            wr_aco_bits=wr_aco, nt=cfg.nt, nr=cfg.nr,
            phase_bit=cfg.phase_bit, compensation=compensation,
            n_probe=n_probe)
        tx = phase_rows(tx_bits, cfg.phase_bit, normalize_by=cfg.nt)
        rx = phase_rows(rx_bits, cfg.phase_bit, normalize_by=cfg.nr)
        # unconjugated kron: the convention the SVD/ACO beams maximize under
        rss = np.asarray(self.provider.measure(
            kron_probe_rows(tx[:, None, :], rx)))
        tx_np, rx_np = tx_bits.cpu().numpy(), rx_bits.cpu().numpy()
        if self.store:
            self.store.save("evaluation_codebook", {
                "rss_dbm": rss, "tx_bits": tx_np, "rx_bits": rx_np})
        return rss, tx_np, rx_np
