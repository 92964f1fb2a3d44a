"""Device ops of the port: frontend, LSTM recurrences and their CUDA
kernels, greedy decoding."""
