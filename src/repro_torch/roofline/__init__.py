"""Roofline tooling on one H100: the card's peaks and the kernels' cost
models (:mod:`repro_torch.roofline.costs`), and the per-(arch x shape)
roofline table over the dry-run's records (:mod:`repro_torch.roofline.report`).
"""
