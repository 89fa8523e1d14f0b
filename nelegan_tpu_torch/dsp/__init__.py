"""DSP front end: STFT, ERB bands, IMCRA, features."""
