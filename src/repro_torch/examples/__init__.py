"""The reference's four examples (``examples/*.py``) on the port, each a
module with a ``main(argv)`` that runs on the card unless ``--device
cpu``:

  python -m repro_torch.examples.quickstart [--device cpu]
  python -m repro_torch.examples.serve_decode [--device cpu]
  python -m repro_torch.examples.train_moe_e2e [--steps 200] [--device cpu]
  python -m repro_torch.examples.elastic_restart [--device cpu]

Where the reference lays its EP world over 8 fake CPU devices, these lay it
over the ranks of a rank-stacked world on one device.
"""
