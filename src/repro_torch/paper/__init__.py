"""The paper's full-participation protocol on the port: Table II
(``table2_accuracy``) and Fig 2 (``fig2_rewards``) through ``run_fl``
(``common``) — counterparts of the repo's ``benchmarks/common.py``,
``table2_accuracy.py`` and ``fig2_rewards.py``, with the same arguments and
defaults plus ``device=``.  Their default output goes under the repo's
git-ignored ``chiprun_out/``."""
