"""Host-resident tables (counterpart of ``hyperspace_tpu.parallel``):
:class:`~hyperspace_torch.parallel.host_table.HostEmbedTable`, the
master table the live index writes through and the streamed IVF build
reads from."""
