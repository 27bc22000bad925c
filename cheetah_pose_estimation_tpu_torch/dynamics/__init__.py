"""Rigid-body dynamics of the cheetah skeleton (port of
``cheetah_pose_estimation_tpu/dynamics``): the equations of motion, the
passive force elements, the forward simulator and the trajectory-generation
tasks."""
