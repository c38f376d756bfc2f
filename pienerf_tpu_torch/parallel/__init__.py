"""Multi-GPU paths over ``torch.distributed``: data-parallel training, the
IP-sharded simulator and the band-sharded frame (``sharding``), and their
parity dryrun (``dryrun``)."""
