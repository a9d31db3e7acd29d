"""The plain reference of the odometry step: PyTorch operations alone,
eager, with no kernel of the program and nothing imported from it. It is
a frozen copy of the port's plain (kernel-free) step, so that a later
change to the program cannot move the yardstick. It runs on the card or
on the CPU; on the card its float32 matrix products run in full float32
unless the caller asks for TF32 (odometry.precision), which is the
control that has to come out as not correct."""
