"""Fleet: the role makers and the collective fleet (the port's copy of
`paddle_tpu/incubate/fleet/`, its base and collective packages)."""
