"""The sequential numpy oracle (port of lqrrt_tpu/oracle)."""
