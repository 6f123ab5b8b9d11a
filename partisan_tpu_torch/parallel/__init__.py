"""The sharded dataplanes ported from ``partisan_tpu/parallel``: the
node-axis mesh (``mesh``) and the sharded dense rounds
(``dense_dataplane``)."""
