// Kernel entry point (twin of reference cpu/kernel/asm/main.asm:
// execution starts here in kernel mode, control_flow.rs:62).  The
// default main hands off to the user program loaded at @USER_BASE with
// a fresh gas counter in user mode; user STOP traps back into
// sys_stop, which halts.  Kernel-only test programs override main.

global main:
    PUSH @USER_BASE
    EXIT_KERNEL
