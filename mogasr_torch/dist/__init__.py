"""Multi-device steps over ``torch.distributed``: the port of mogasr/dist/.

``launch.run_ranks`` starts the ranks (one process each), ``mesh`` holds a
rank's view of its group, ``comm`` the collectives the steps use. The steps:
data-parallel (``sharded``), tensor-parallel (``tensor_parallel``),
expert-parallel (``expert_parallel``), sequence-parallel
(``sequence_parallel``) and pipeline-parallel (``pipeline_parallel``).
"""
