"""The part of `paddle_tpu/autoshard/` the trainer supervisor reads:
`elastic.py`'s plan-table shrink policy (stdlib only). The planner itself
and placement emission are ROADMAP Queue 1 item 9."""
