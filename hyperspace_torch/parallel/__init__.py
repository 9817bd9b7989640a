"""Host-resident tables (counterpart of ``hyperspace_tpu.parallel``):
:class:`~hyperspace_torch.parallel.host_table.HostEmbedTable`, the
master table the live index writes through, the streamed IVF build
reads from and the host-resident trainer (``train/host_embed.py``)
trains through a
:class:`~hyperspace_torch.parallel.host_table.DeviceHotCache`."""
