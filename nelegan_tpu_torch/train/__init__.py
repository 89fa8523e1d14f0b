"""GAN training steps, exact-resume checkpoints and the replay buffer."""
